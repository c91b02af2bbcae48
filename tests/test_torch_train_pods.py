"""The sharded train step on a multi-pod mesh, on the CPU.

``TRAIN_RULES`` shard the batch and the parameters' FSDP dimension over
pod and data together. The step runs with those two mesh dimensions
flattened into one (``training.steps.flat_batch_mesh``), so a step on a
2x2x2 ``("pod", "data", "model")`` mesh is the step on the 4x2 ``("data",
"model")`` mesh of the same ranks:

* counted on a fake world of eight ranks, in one process
  (``tests/torch_dryrun_worker.py``, part ``pods``): a reduced zamba2-2.7b
  train step (batch 8 of 32 tokens) moves at most 1.25x the collective
  bytes a rank on the 2x2x2 mesh that it moves on the 4x2 one;
* run on eight gloo processes (``tests/torch_step_worker.py``, its own
  deadline) on the 2x2x2 mesh: a reduced zamba2-2.7b step, its batch
  placed over pod and data, hands AdamW the gradients of the one-device
  port (1e-5 relative L2 a tensor) and of the JAX package (2e-5), its
  moments placed as its parameters on the caller's mesh.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_sharded_step as step  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "torch_dryrun_worker.py")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: the counted steps' deadline and the gloo group's, seconds: 300 s, over 10x their time alone on an idle 8-core
#: CPU (18 s and 15 s; under the full suite's 6 pytest workers 23-33 s and 28-29 s)
PODS_DEADLINE = 300.0
GLOO_DEADLINE = 300.0
#: a multi-pod step's collective bytes a rank at most this times the flat mesh's
PODS_FACTOR = 1.25
CASE = dict(name="zamba2-2.7b_pods", arch="zamba2-2.7b", placed=True, h3=False, mesh="2x2x2")


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """The worker's ``pods`` part: each mesh's counts."""
    work = str(tmp_path_factory.mktemp("pods"))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, WORKER, work, "pods"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, env=env, timeout=PODS_DEADLINE)
    assert proc.returncode == 0 and "DRYRUN_WORKER_OK" in proc.stdout, proc.stdout[-3000:]
    with open(os.path.join(work, "pods.json")) as fh:
        return json.load(fh)["pods"]


@pytest.fixture(scope="module")
def gloo_pods(tmp_path_factory):
    """The eight ranks' step on the 2x2x2 mesh: ``(outputs, infos)``."""
    return step.run_group(tmp_path_factory.mktemp("gloo_pods"), [CASE], [], GLOO_DEADLINE)


def test_a_multi_pod_step_moves_what_the_flat_step_moves(pods):
    multi, flat = (sum(pods[m]["costs"]["collective_bytes"].values()) for m in ("2x2x2", "4x2"))
    assert 0 < multi <= PODS_FACTOR * flat, (pods["2x2x2"]["costs"], pods["4x2"]["costs"])
    assert pods["2x2x2"]["costs"]["dot_flops"] == pods["4x2"]["costs"]["dot_flops"]


@pytest.mark.parametrize("reference", ["port", "jax"])
def test_multi_pod_step_gradients_equal_the_one_device_gradients(gloo_pods, reference):
    outs, infos = gloo_pods
    name = CASE["name"]
    loss, _, want = step.one_device_step(json.dumps(CASE, sort_keys=True), reference)
    tol = step.GRAD_TOL if reference == "port" else 2e-5
    for rank in range(step.WORLD):
        np.testing.assert_allclose(outs[rank][f"step/{name}/loss"], loss, rtol=step.LOSS_RTOL)
        assert infos[rank][f"step/{name}/moment_placements_match"] is True
        got = {n[len(f"step/{name}/g/"):]: v for n, v in outs[rank].items() if n.startswith(f"step/{name}/g/")}
        assert set(got) == set(want)
        for n, w in want.items():
            assert np.linalg.norm(w) > 0, n
            assert step._rel_l2(got[n], w) <= tol, (rank, n, step._rel_l2(got[n], w))
