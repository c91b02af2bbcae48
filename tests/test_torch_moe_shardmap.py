"""The port's sharding on a 2x4 mesh of eight gloo processes, and H3 (the
expert-parallel MoE, ``blocks.moe_apply_shardmap``), on the CPU.

One run of eight processes (``tests/torch_dist_worker.py``, meeting through
a ``FileStore`` under ``tmp_path``, each at one thread) serves every 2x4
check; ``tests/procs.py`` holds it to a deadline and dumps each rank's
output tails on failure. The checks:

* each rank's local shard of llama3-8b-reduced and dbrx-reduced tensors,
  placed by ``placements_for(spec_for(...))`` under the three rule tables,
  is the slice that the JAX ``NamedSharding(mesh, spec).devices_indices_map``
  gives the device at the same place of a 2x4 mesh of eight CPU devices
  (computed once in a JAX subprocess);
* H3 on a reduced dbrx layer with ``capacity_factor = num_experts``, from
  plain tensors and from DTensors placed by the train and serve rules, is
  within 1e-5 of the port's ``moe_dense_ref`` and of the JAX
  ``moe_dense_ref`` on the same numpy inputs, and keeps x's placements;
* where the JAX code falls back (``E % tp``, a batch that does not divide,
  no batch axis, ``tp <= 1``), H3 is bit-equal to ``moe_apply``;
* a reduced dbrx forward with H3 on equals the one with it off.

The 1x1 gloo mesh's fallback runs in this process. H3's backward is held in
``tests/test_torch_sharded_step.py``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from procs import ProcSet, run_py  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import make_smoke_mesh  # noqa: E402
from repro_torch.models import blocks, build_model, optim  # noqa: E402
from repro_torch.models.params import decoder_specs, named_specs  # noqa: E402

WORLD = 8
DEADLINE = 300.0
H3_TOL = 1e-5
WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")

#: the placed tensors: (arch, name) of the reduced configs' parameters and
#: their decode cache's K, each under the three rule tables
PLACED = [("llama3-8b", n) for n in ("embed", "layers/attn/wq", "layers/attn/wk", "layers/ffn/w_down", "head",
                                     "cache:layers/k")]
PLACED += [("dbrx-132b", n) for n in ("layers/ffn/w_gate", "layers/ffn/w_down", "layers/ffn/router")]
TABLES = ("train", "serve", "long_serve")


def _spec_of(arch, name):
    cfg = get_config(arch).reduced()
    if name.startswith("cache:"):
        return dict(named_specs(build_model(cfg).cache_specs(4, 32)))[name[len("cache:"):]]
    return dict(decoder_specs(cfg))[name]


CASES = [dict(arch=a, name=n, table=t, shape=list(_spec_of(a, n).shape), axes=list(_spec_of(a, n).axes))
         for a, n in PLACED for t in TABLES]

_JAX_SLICES = r"""
import json
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding
from repro.sharding import rules

cases = json.load(open(CASES_JSON))
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
tables = {"train": rules.TRAIN_RULES, "serve": rules.SERVE_RULES, "long_serve": rules.LONG_SERVE_RULES}
out = []
for c in cases:
    shape = tuple(c["shape"])
    spec = rules.spec_for(shape, tuple(c["axes"]), tables[c["table"]], mesh)
    where = NamedSharding(mesh, spec).devices_indices_map(shape)
    out.append([[[s.start or 0, n if s.stop is None else s.stop] for s, n in zip(where[d], shape)]
                for d in mesh.devices.flat])
json.dump(out, open(SLICES_JSON, "w"))
print("SLICES_OK")
"""


def _moe_inputs():
    """A reduced dbrx MoE layer (the norm's gamma drawn nonzero) and its
    input [4, 12, d_model], f32."""
    cfg = get_config("dbrx-132b").reduced()
    d, E, fe = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    rng = np.random.default_rng(0)
    p = {"ln": rng.standard_normal(d) * 0.1, "router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w_gate": rng.standard_normal((E, d, fe)) / np.sqrt(d), "w_up": rng.standard_normal((E, d, fe)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, fe, d)) / np.sqrt(fe)}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    return p, rng.standard_normal((4, 12, d)).astype(np.float32)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """The JAX slices, then the eight ranks: ``(slices, outputs, infos)``,
    one output dict and one info dict a rank."""
    work = tmp_path_factory.mktemp("gloo")
    p, x = _moe_inputs()
    np.savez(work / "inputs.npz", x=x, **{f"p/{n}": v for n, v in p.items()})
    with open(work / "cases.json", "w") as fh:
        json.dump(CASES, fh)
    code = f"CASES_JSON = {str(work / 'cases.json')!r}\nSLICES_JSON = {str(work / 'slices.json')!r}\n" + _JAX_SLICES
    assert "SLICES_OK" in run_py(code, devices=WORLD, deadline=DEADLINE)
    with ProcSet(str(work / "logs")) as procs:
        ranks = [procs.spawn(f"rank{r}", [sys.executable, WORKER, str(r), str(WORLD), str(work)])
                 for r in range(WORLD)]
        for rank in ranks:
            assert rank.wait(deadline=DEADLINE) == 0, procs.failure_report()
    with open(work / "slices.json") as fh:
        slices = json.load(fh)
    outs = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    infos = []
    for r in range(WORLD):
        with open(work / f"rank{r}.json") as fh:
            infos.append(json.load(fh))
    return slices, outs, infos


@pytest.mark.parametrize("i", range(len(CASES)), ids=[f"{c['arch']}:{c['name']}:{c['table']}" for c in CASES])
def test_each_rank_holds_the_jax_shard(gloo_run, i):
    slices, outs, infos = gloo_run
    full = np.arange(int(np.prod(CASES[i]["shape"])), dtype=np.float32).reshape(CASES[i]["shape"])
    for rank in range(WORLD):
        want = full[tuple(slice(a, b) for a, b in slices[i][rank])]
        assert np.array_equal(outs[rank][f"place/{i}"], want), (rank, infos[rank]["cases"][i])


def test_some_cases_shard_over_both_axes_and_nest(gloo_run):
    """The cases exercise sharding: each axis alone, both on one tensor,
    and one dimension over both (the serve rules' experts)."""
    _, _, infos = gloo_run
    specs = [c["spec"] for c in infos[0]["cases"]]
    assert any(["data", "model"] in s for s in specs)
    assert any("data" in s and "model" in s for s in specs)
    assert any(all(e is None for e in s) for s in specs)  # and a replicated one


def _jax_dense_ref():
    p, x = _moe_inputs()
    cfg = jax_get_config("dbrx-132b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return np.asarray(jax_blocks.moe_dense_ref(cfg, {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("form", ["plain", "train", "serve"])
def test_h3_matches_the_dense_oracles(gloo_run, form):
    _, outs, infos = gloo_run
    jax_ref = _jax_dense_ref()
    for rank in range(WORLD):
        got = outs[rank][f"h3/{form}"]
        assert np.abs(got - outs[rank]["h3/dense_ref"]).max() <= H3_TOL
        assert np.abs(got - jax_ref).max() <= H3_TOL
        if form != "plain":
            assert infos[rank][f"h3_{form}_same_placements"], infos[rank][f"h3_{form}_placements"]


@pytest.mark.parametrize("case", ["experts_indivisible", "batch_indivisible", "no_batch_axis", "tp_1"])
def test_h3_falls_back_where_the_jax_code_does(gloo_run, case):
    _, outs, infos = gloo_run
    for rank in range(WORLD):
        assert infos[rank]["fallback_equal"][case] is True
        assert np.array_equal(outs[rank][f"fallback/{case}"], outs[0][f"fallback/{case}"])


def test_decoder_takes_h3_under_the_flag(gloo_run):
    _, outs, _ = gloo_run
    for rank in range(WORLD):
        off, h3 = outs[rank]["model/off"], outs[rank]["model/h3"]
        assert np.isfinite(h3).all() and np.abs(h3 - off).max() <= H3_TOL * max(1.0, np.abs(off).max())


# -- the 1x1 mesh in this process --------------------------------------------------------


@pytest.fixture()
def smoke_mesh():
    mesh = make_smoke_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def _torch_layer(cfg):
    p, x = _moe_inputs()
    return {n: torch.from_numpy(v) for n, v in p.items()}, torch.from_numpy(x)


def test_h3_on_one_device_is_moe_apply(smoke_mesh):
    """The 1x1 mesh takes the reference's ``tp <= 1`` fallback, from plain
    tensors and from DTensors, and the decoder's switch takes H3."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.sharding import SERVE_RULES, placements_for, sharding_for, spec_for

    cfg = get_config("dbrx-132b").reduced()
    p, x = _torch_layer(cfg)
    specs = blocks.moe_specs(cfg)
    with torch.no_grad():
        want = blocks.moe_apply(cfg, p, x)
        with optim.optimizations(mesh=smoke_mesh, shardmap_moe=True):
            got = blocks.moe_apply_shardmap(cfg, p, x)
            placed = {n: distribute_tensor(t, smoke_mesh, sharding_for(specs[n], SERVE_RULES, smoke_mesh))
                      for n, t in p.items()}
            xspec = spec_for(tuple(x.shape), ("batch", "seq", "act_embed"), SERVE_RULES, smoke_mesh)
            xd = distribute_tensor(x, smoke_mesh, placements_for(xspec, smoke_mesh))
            gd = blocks.moe_apply_shardmap(cfg, placed, xd)
    assert not isinstance(got, DTensor) and torch.equal(got, want)
    assert isinstance(gd, DTensor) and gd.placements == xd.placements and torch.equal(gd.full_tensor(), want)
