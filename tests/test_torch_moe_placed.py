"""The MoE's placed dispatch with H3 off (``blocks._moe_placed``) on a 2x4
mesh of eight gloo processes, on the CPU, where the experts overflow.

Reduced dbrx-132b and deepseek-v3-671b (its dense prefix layer and shared
expert) at a capacity factor of 0.5, so that one device drops pairs: each
rank dispatches its own tokens, places each pair in its expert's group by
the counts of the ranks before it, and the buffer is summed over the batch
dimension. Two groups of eight ranks (``tests/torch_step_worker.py`` and
``tests/torch_serve_worker.py``, each group under its own deadline): a
train step on parameters placed by ``TRAIN_RULES`` (the experts over the
model axis, their FSDP dimension over the data axis), whose gradients must
equal the one-device port's (1e-5 relative L2 a tensor) and the JAX
package's (2e-5); a prefill and two decode steps on parameters placed by
``SERVE_RULES`` (the experts over the data and the model axes: the buffer
reduce-scattered to each rank's own experts, their outputs gathered back),
whose logits and caches must equal both packages' likewise; and in both,
the pairs dropped (``blocks.DROPPED``) equal to the one-device port's, on
every rank. One reduced dbrx MoE layer's forward and backward are counted
on the ranks (``op_costs.count``) at a batch of 4 and of 8: its
all-gathers do not grow with the tokens (the expert weights' FSDP gather
and the ``[E]`` counts, never the tokens or the routing indices).
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_sharded_serve as serve  # noqa: E402
import test_torch_sharded_step as step  # noqa: E402
from torch_step_worker import _cfg  # noqa: E402

from repro_torch.models import blocks, build_model  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402

#: the capacity factor at which one device drops pairs of both reduced archs
FACTOR = 0.5
ARCHS = ["dbrx-132b", "deepseek-v3-671b"]
STEP_CASES = [dict(name=f"{a}_overflow", arch=a, placed=True, h3=False, capacity_factor=FACTOR) for a in ARCHS]
SERVE_CASES = [dict(name=f"{a}_overflow", arch=a, h3=False, capacity_factor=FACTOR) for a in ARCHS]
#: each group's deadline, seconds: 300 s, over 10x its time alone on an idle 8-core CPU (27 s and 10 s; under the
#: full suite's 6 pytest workers 74-75 s and 36-37 s)
STEP_DEADLINE = 300.0
SERVE_DEADLINE = 300.0


@pytest.fixture(scope="module")
def gloo_step(tmp_path_factory):
    """The eight ranks' train steps of the overflow cases and the counted
    MoE layer: ``(outputs, infos)``."""
    return step.run_group(tmp_path_factory.mktemp("placed_step"), STEP_CASES, ["moe_gathers"], STEP_DEADLINE)


@pytest.fixture(scope="module")
def gloo_serve(tmp_path_factory):
    """The eight ranks' serving of the overflow cases: ``(rank 0's
    tensors, every rank's info)``."""
    return serve.run_group(tmp_path_factory.mktemp("placed_serve"), SERVE_CASES, SERVE_DEADLINE)


def _case(cases, arch):
    return next(c for c in cases if c["arch"] == arch)


@functools.lru_cache(maxsize=None)
def _one_device_dropped(arch, kind):
    """``[routed, dropped]`` pairs of the one-device port: a train step's
    forward (the step's batch) or a prefill and two decode steps (the
    serve inputs)."""
    case = _case(STEP_CASES if kind == "step" else SERVE_CASES, arch)
    cfg = _cfg(case)
    model = build_model(cfg)
    params = from_numpy(step._weights(arch), "cpu")
    blocks.DROPPED.reset()
    with torch.no_grad():
        if kind == "step":
            model.forward(params, {"tokens": torch.from_numpy(step._batch(case)["tokens"]).long()})
        else:
            inp = serve._inputs(case)
            _, cache, n = model.prefill(params, {"tokens": torch.from_numpy(inp["tokens"]).long()},
                                        max_len=serve.MAX_LEN)
            for i in range(2):
                _, cache = model.decode(params, cache, torch.from_numpy(inp[f"step{i}"]).long(), n + i)
    return [blocks.DROPPED.routed, blocks.DROPPED.dropped]


def test_the_one_device_port_drops_pairs_at_this_factor():
    for arch in ARCHS:
        for kind in ("step", "serve"):
            routed, dropped = _one_device_dropped(arch, kind)
            assert 0 < dropped < routed, (arch, kind, routed, dropped)


@pytest.mark.parametrize("reference", ["port", "jax"])
@pytest.mark.parametrize("arch", ARCHS)
def test_overflowing_step_gradients_equal_the_one_device_gradients(gloo_step, arch, reference):
    outs, infos = gloo_step
    case = _case(STEP_CASES, arch)
    name = case["name"]
    loss, _, want = step.one_device_step(json.dumps(case, sort_keys=True), reference)
    tol = serve.PORT_TOL if reference == "port" else serve.JAX_TOL
    for rank in range(step.WORLD):
        np.testing.assert_allclose(outs[rank][f"step/{name}/loss"], loss, rtol=step.LOSS_RTOL)
        got = {n[len(f"step/{name}/g/"):]: v for n, v in outs[rank].items() if n.startswith(f"step/{name}/g/")}
        assert set(got) == set(want)
        for n, w in want.items():
            assert np.linalg.norm(w) > 0, n
            assert step._rel_l2(got[n], w) <= tol, (rank, n, step._rel_l2(got[n], w))


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("arch", ARCHS)
def test_overflowing_serve_equals_one_device(gloo_serve, arch, package):
    got, _ = gloo_serve
    case = _case(SERVE_CASES, arch)
    want = serve.reference(json.dumps(case, sort_keys=True), package)
    tol = serve.PORT_TOL if package == "port" else serve.JAX_TOL
    name = case["name"]
    assert set(want) == {k[len(name) + 1:] for k in got if k.startswith(name + "/")}
    for key, w in want.items():
        g = got[f"{name}/{key}"]
        assert g.shape == w.shape and np.linalg.norm(w) > 0, key
        assert step._rel_l2(g, w) <= tol, (key, step._rel_l2(g, w))


@pytest.mark.parametrize("kind", ["step", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_placed_dispatch_drops_the_one_device_pairs(gloo_step, gloo_serve, arch, kind):
    """Every rank counts the pairs the whole batch routed and dropped, as
    one device counts them, and every MoE call went through the placed
    dispatch."""
    cfg = _cfg(_case(STEP_CASES, arch))
    moe_layers = cfg.num_layers - cfg.moe.first_dense
    if kind == "step":
        infos, key, calls = gloo_step[1], f"step/{arch}_overflow/dropped", moe_layers
    else:
        infos, key, calls = gloo_serve[1], f"{arch}_overflow/dropped", 3 * moe_layers
    want = _one_device_dropped(arch, kind)
    for info in infos:
        routed, dropped, placed = info[key]
        assert [routed, dropped] == want, (arch, kind, info[key], want)
        assert placed == calls


def test_one_moe_layers_all_gathers_do_not_grow_with_the_tokens(gloo_step):
    """A reduced dbrx MoE layer's forward and backward, H3 off, on the 2x4
    mesh under ``TRAIN_RULES``: at twice the tokens it issues the same
    all-gathers, byte for byte, on every rank (what it gathers is the
    experts' weights and the ``[E]`` counts). The buffer's sums, which the
    JAX package's partitioner also makes, grow with the tokens."""
    _, infos = gloo_step
    for info in infos:
        small, large = info["moe_gathers"]["4"], info["moe_gathers"]["8"]
        assert small["counts"]["all-gather"] > 0
        assert large["counts"]["all-gather"] == small["counts"]["all-gather"], (small, large)
        assert large["bytes"]["all-gather"] == small["bytes"]["all-gather"], (small, large)
        assert large["bytes"]["all-reduce"] > small["bytes"]["all-reduce"]
