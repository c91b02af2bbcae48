"""The port's dry run held to the JAX package's own, cell by cell, on the CPU.

The parity bound of a cell (one arch, shape, mesh and set of ``--opt``
flags): the port's collective bytes a device a step are at most
``PARITY_FACTOR`` times the JAX package's plus ``PARITY_SLACK_BYTES``.
The slack is for the two counting methods, not for layouts: the port
counts the eager ops each rank's DTensor blocks go through
(``launch/op_costs.py``), the JAX package the HLO that XLA compiled,
after fusion. A layout that moves what the rules' placements do not need
(a decode that gathers each rank's whole cache, an embedding lookup that
gathers the whole table, H3 gathering every expert of a layer) lands
orders of magnitude past it.

The JAX side runs the JAX package's entry point, ``python -m
repro.launch.dryrun`` (the only place that may fake 512 host devices), one
subprocess for each (arch, shape, flags), side by side; the port's side
runs ``repro_torch.launch.dryrun.run_cell`` in subprocesses of its own
over a fake process group of 512 ranks. Each subprocess has a deadline.
The cells, at full size: zamba2-2.7b's decode_32k on the 16x16 and the
2x16x16 meshes (its shared block's 32 KV heads over the 16-way model
axis: the decode attends where the cache lies) and its long_500k (batch
1, the ring; the embedding table looked up by vocab block), deepseek-v3's
decode_32k under H3 (``--opt shardmap_moe``: each rank's 16 experts of a
layer, never its 256), held under the JAX package's own figure, and
llama3-8b's decode_32k on both meshes (its 8 KV heads do not divide the
model axis, and both packages gather the cache's head_dim).
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
DEADLINE = 240.0
PARITY_FACTOR = 3
PARITY_SLACK_BYTES = 64e6

#: (arch, shape, meshes, flags) of each subprocess a side
RUNS = [
    ("zamba2-2.7b", "decode_32k", ("single", "multi"), ()),
    ("zamba2-2.7b", "long_500k", ("single",), ()),
    ("deepseek-v3-671b", "decode_32k", ("single",), ("shardmap_moe",)),
    ("llama3-8b", "decode_32k", ("single", "multi"), ()),
]
CELLS = [(arch, shape, mesh, opts) for arch, shape, meshes, opts in RUNS for mesh in meshes]

PORT_SCRIPT = """
import json, sys
import torch
from repro_torch.launch import dryrun
torch.set_num_threads(2)
dryrun.start_fake_world(512)
arch, shape, meshes, opts, out = json.loads(sys.argv[1])
recs = {m: dryrun.run_cell(arch, shape, multi_pod=m == "multi", opt={o: True for o in opts}, verbose=False)
        for m in meshes}
with open(out, "w") as fh:
    json.dump(recs, fh)
"""


def _tag(arch, shape, mesh, opts):
    return "__".join([arch, shape, mesh, *sorted(opts)])


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """``{(side, tag): record}`` of every cell, both sides' subprocesses
    run side by side."""
    work = tmp_path_factory.mktemp("dryrun_reference")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    procs = []
    for i, (arch, shape, meshes, opts) in enumerate(RUNS):
        mesh = meshes[0] if len(meshes) == 1 else "both"
        jax_out = work / f"jax{i}"
        cmd = [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", str(jax_out)] + [a for o in opts for a in ("--opt", o)]
        procs.append(("jax", i, jax_out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                          text=True, env=env)))
        port_out = work / f"port{i}.json"
        arg = json.dumps([arch, shape, list(meshes), list(opts), str(port_out)])
        procs.append(("port", i, port_out, subprocess.Popen([sys.executable, "-c", PORT_SCRIPT, arg],
                                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                            text=True, env=env)))
    out = {}
    try:
        for side, i, path, proc in procs:
            log, _ = proc.communicate(timeout=DEADLINE)
            assert proc.returncode == 0, (side, RUNS[i], log[-3000:])
            arch, shape, meshes, opts = RUNS[i]
            if side == "port":
                with open(path) as fh:
                    for mesh, rec in json.load(fh).items():
                        out[("port", _tag(arch, shape, mesh, opts))] = rec
                continue
            for mesh in meshes:
                name = "__".join([arch, shape, mesh] + (["_".join(sorted(opts))] if opts else [])) + ".json"
                with open(path / name) as fh:
                    out[("jax", _tag(arch, shape, mesh, opts))] = json.load(fh)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _collective_bytes(rec):
    assert rec["ok"], rec.get("error")
    return float(rec["collective_bytes_per_device"])


@pytest.mark.parametrize("arch,shape,mesh,opts", CELLS, ids=[_tag(*c) for c in CELLS])
def test_collectives_within_the_parity_bound(records, arch, shape, mesh, opts):
    tag = _tag(arch, shape, mesh, opts)
    ref, port = _collective_bytes(records[("jax", tag)]), _collective_bytes(records[("port", tag)])
    assert ref > 0
    assert records[("port", tag)]["mesh"] == ("2x16x16" if mesh == "multi" else "16x16")
    assert port <= PARITY_FACTOR * ref + PARITY_SLACK_BYTES, (tag, port, ref)


def test_h3_under_the_serve_rules_moves_less_than_the_jax_h3(records):
    """deepseek-v3's decode_32k with H3: each rank takes its 16 experts of
    a layer by one all-gather over the data axis (the JAX H3's
    ``P(model)`` in_specs gather more), so the port moves less than the
    JAX package does, not only within the bound."""
    tag = _tag("deepseek-v3-671b", "decode_32k", "single", ("shardmap_moe",))
    assert _collective_bytes(records[("port", tag)]) < _collective_bytes(records[("jax", tag)])
