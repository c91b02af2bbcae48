"""The port's sharded train step on a 2x4 mesh of eight gloo processes,
H1 over a ``DeviceMesh`` and H3's backward, on the CPU.

One run of eight processes (``tests/torch_step_worker.py``, meeting through
a ``FileStore`` under the module's tmp dir, each at one thread) serves
every 2x4 check, and one JAX subprocess of eight faked CPU devices
(``tests/procs.run_py``) computes the JAX side that needs a mesh. Inputs
are drawn with numpy from a seed; weights are the JAX init's, carried
across with the port's ``from_numpy``. The checks:

* (1) ``make_train_step`` on parameters and moments placed by
  ``TRAIN_RULES`` (``place_tree``), the batch replicated or placed by
  ``("batch", "seq")``, equals the port's one-device step and the JAX
  one-device step (loss rtol 1e-4, parameters 5e-3: the bounds of
  ``test_train_step_numerics_invariant_to_sharding``), and the gradients
  it hands the optimizer equal theirs to 1e-5 relative L2 a tensor on
  every rank (AdamW's first step moves an element by at most ``lr``
  whatever its gradient, so the parameters alone cannot tell a wrong
  gradient; a gradient ``dp`` times too large, or left unreduced, is a
  relative distance of 1 or more), for reduced
  llama3-8b, gemma2-2b (window, softcaps, tied head) and dbrx with H3 off
  and on (``capacity_factor = num_experts``, so that H3's per-rank
  capacity drops nothing either); reduced llama3-8b's step over two
  microbatches (``accum=2``) and its GRPO step (``make_grpo_step``); and
  reduced deepseek-v3 (MLA on each rank's block of the query heads, its
  dense prefix layer and shared expert) with H3 off and on, internvl2-2b
  (its patches placed before the tokens, the loss past them) and
  hubert-xlarge (frames, targets and mask placed; masked prediction);
* (2) under H1 (``shard_attn_heads``), the forward of a reduced llama3-8b
  with 8 query and 2 KV heads (K/V do not divide the 4-way model axis, so
  they are broadcast) equals the port's plain forward, the JAX plain
  forward and the JAX H1 forward under an ``AxisType.Auto`` 2x4 mesh,
  within rtol = atol = 2e-4; the attention saw [B/2, H/4, S, hd] blocks;
* (3) H3's gradients (of ``sum(moe_apply_shardmap(...)**2)`` over a
  reduced dbrx layer with ``capacity_factor = num_experts``), from plain
  tensors and from DTensors placed by ``TRAIN_RULES``, equal the port's
  ``moe_dense_ref``'s and the JAX H3 gradients to 1e-5 relative L2 on every
  rank (a ``tp``-fold error is a relative distance of 3);
* (4) ``global_norm`` and ``AdamW.update`` on DTensors equal the plain ones
  bit for bit on every rank (the gradients are multiples of 1/8, so every
  order of their squares' sums is exact).

In this process, on the 1x1 gloo smoke mesh: the hybrid and the xLSTM
refuse DTensor parameters by name.
"""

import dataclasses
import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from procs import ProcSet, run_py  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.training import AdamW as JaxAdamW  # noqa: E402
from repro.training import make_grpo_step as jax_make_grpo_step  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import blocks, build_model  # noqa: E402
from repro_torch.models.params import decoder_specs, from_numpy  # noqa: E402
from repro_torch.training import AdamW, make_grpo_step, make_train_step  # noqa: E402

WORLD = 8
DEADLINE = 300.0
LOSS_RTOL, PARAM_TOL = 1e-4, 5e-3
LR = 1e-3  # the steps' learning rate (the worker's too)
H1_TOL = 2e-4
H3_TOL = 1e-5
GRAD_TOL = 1e-5  # relative L2 of each step gradient
WORKER = os.path.join(os.path.dirname(__file__), "torch_step_worker.py")
sys.path.insert(0, os.path.dirname(__file__))
from torch_step_worker import Recording, _cfg  # noqa: E402

#: the step cases: name, arch, batch placed, H3 (``accum`` microbatches, or
#: the GRPO step)
STEP_CASES = [
    dict(name="llama3-8b_replicated", arch="llama3-8b", placed=False, h3=False),
    dict(name="llama3-8b_placed", arch="llama3-8b", placed=True, h3=False),
    dict(name="gemma2-2b_replicated", arch="gemma2-2b", placed=False, h3=False),
    dict(name="gemma2-2b_placed", arch="gemma2-2b", placed=True, h3=False),
    dict(name="dbrx-132b_h3_off", arch="dbrx-132b", placed=True, h3=False),
    dict(name="dbrx-132b_h3_on", arch="dbrx-132b", placed=True, h3=True),
    dict(name="llama3-8b_accum2", arch="llama3-8b", placed=True, h3=False, accum=2),
    dict(name="llama3-8b_grpo", arch="llama3-8b", placed=True, h3=False, grpo=True),
    dict(name="deepseek-v3-671b_h3_off", arch="deepseek-v3-671b", placed=True, h3=False),
    dict(name="deepseek-v3-671b_h3_on", arch="deepseek-v3-671b", placed=True, h3=True),
    dict(name="internvl2-2b_placed", arch="internvl2-2b", placed=True, h3=False),
    dict(name="hubert-xlarge_placed", arch="hubert-xlarge", placed=True, h3=False),
]
CASES = {c["name"]: c for c in STEP_CASES}
H1_CASE = dict(arch="llama3-8b", heads=[8, 2])
H1_VOCAB = get_config("llama3-8b").reduced().vocab


def _jax_cfg(case):
    """The JAX package's config of a worker case (``_cfg``'s overrides)."""
    cfg = jax_get_config(case["arch"]).reduced()
    if case.get("heads"):
        cfg = dataclasses.replace(cfg, num_heads=case["heads"][0], num_kv_heads=case["heads"][1])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg


@functools.lru_cache(maxsize=None)
def _weights(arch, heads=None):
    """The JAX init's weights by name (f32 numpy) of a reduced config."""
    cfg = _jax_cfg(dict(arch=arch, heads=list(heads) if heads else None))
    return {k: np.asarray(v) for k, v in named_tensors(jax_build_model(cfg).init(jax.random.PRNGKey(0),
                                                                                  jnp.float32)).items()}


def _jax_tree(jm, named):
    template = jm.init(jax.random.PRNGKey(0), jnp.float32)
    return jax.tree.unflatten(jax.tree.structure(template), [jnp.asarray(named[k]) for k in named_tensors(template)])


def _tokens(seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(8, 16)).astype(np.int32)


def _model_inputs(arch, seed):
    """A batch of 8 of a reduced ``arch``'s model inputs as numpy: 16
    tokens (a VLM's after its patches, drawn from ``seed + 3``), or an
    encoder's 16 frames with their targets and a mask of about half the
    positions."""
    cfg = get_config(arch).reduced()
    if cfg.encoder_only:
        rng = np.random.default_rng(seed + 4)
        return {"frames": rng.standard_normal((8, 16, cfg.frontend_dim)).astype(np.float32),
                "targets": rng.integers(0, cfg.vocab, size=(8, 16)).astype(np.int32),
                "mask": rng.random((8, 16)) < 0.5}
    out = {"tokens": _tokens(seed, cfg.vocab)}
    if cfg.num_patches:
        out["patches"] = np.random.default_rng(seed + 3).standard_normal((8, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    return out


def _batch(case):
    """A step case's batch as numpy: its model inputs, and a GRPO case's
    behaviour logprobs, advantages and loss mask (the last 10 positions)."""
    batch = _model_inputs(case["arch"], 1)
    if case.get("grpo"):
        rng = np.random.default_rng(3)
        mask = np.zeros((8, 15), dtype=bool)
        mask[:, 5:] = True
        batch.update(behavior_logprobs=np.where(mask, -rng.uniform(0.5, 6.0, (8, 15)), 0.0).astype(np.float32),
                     advantages=rng.standard_normal(8).astype(np.float32), loss_mask=mask)
    return batch


def _moe_inputs():
    """A reduced dbrx MoE layer (the norm's gamma drawn nonzero) and its
    input [4, 12, d_model], f32."""
    cfg = get_config("dbrx-132b").reduced()
    d, E, fe = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    rng = np.random.default_rng(0)
    p = {"ln": rng.standard_normal(d) * 0.1, "router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w_gate": rng.standard_normal((E, d, fe)) / np.sqrt(d), "w_up": rng.standard_normal((E, d, fe)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, fe, d)) / np.sqrt(fe)}
    return {n: v.astype(np.float32) for n, v in p.items()}, rng.standard_normal((4, 12, d)).astype(np.float32)


def _optim_inputs():
    """Parameters, gradients (multiples of 1/8) and moments of a reduced
    llama3-8b's shapes."""
    rng = np.random.default_rng(7)
    out = {}
    for n, spec in decoder_specs(get_config("llama3-8b").reduced()):
        out[f"p/{n}"] = rng.standard_normal(spec.shape).astype(np.float32)
        out[f"g/{n}"] = (rng.integers(-8, 8, spec.shape) / 8).astype(np.float32)
        out[f"mu/{n}"] = (rng.standard_normal(spec.shape) * 1e-2).astype(np.float32)
        out[f"nu/{n}"] = (rng.standard_normal(spec.shape) * 1e-2).astype(np.float32) ** 2
    return out


_JAX_MESH_SIDE = r"""
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import blocks, build_model, optim
from repro.models.params import named_tensors

mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
out = {}

# H1's forward of the 8/2-head llama3-8b, under the Auto mesh
cfg = dataclasses.replace(get_config("llama3-8b").reduced(), num_heads=8, num_kv_heads=2)
model = build_model(cfg)
data = np.load(WORK + "/h1.npz")
template = model.init(jax.random.PRNGKey(0), jnp.float32)
params = jax.tree.unflatten(jax.tree.structure(template),
                            [jnp.asarray(data["p/" + k]) for k in named_tensors(template)])
toks = jnp.asarray(data["tokens"])
with mesh, optim.optimizations(mesh=mesh, shard_attn_heads=True):
    out["h1_logits"] = np.asarray(jax.jit(lambda p, t: model.forward(p, {"tokens": t}))(params, toks))

# H3's gradients of sum(y**2) on the same mesh
cfg = get_config("dbrx-132b").reduced()
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
data = np.load(WORK + "/moe.npz")
p = {n[2:]: jnp.asarray(data[n]) for n in data.files if n.startswith("p/")}
x = jnp.asarray(data["x"])
with mesh, optim.optimizations(mesh=mesh, shardmap_moe=True):
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(blocks.moe_apply_shardmap(cfg, p, x) ** 2), argnums=(0, 1)))(p, x)
for n, g in gp.items():
    out["h3/" + n] = np.asarray(g)
out["h3/x"] = np.asarray(gx)
np.savez(WORK + "/jax_mesh.npz", **out)
print("JAX_MESH_OK")
"""


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """The inputs, the eight ranks and the JAX mesh subprocess side by
    side: ``(outputs, infos, jax_mesh)``, one output and one info dict a
    rank."""
    work = tmp_path_factory.mktemp("gloo_step")
    for case in STEP_CASES:
        named = _weights(case["arch"])
        np.savez(work / f"step_{case['name']}.npz", **_batch(case), **{f"p/{n}": v for n, v in named.items()})
    with open(work / "steps.json", "w") as fh:
        json.dump(STEP_CASES, fh)
    named = _weights("llama3-8b", (8, 2))
    np.savez(work / "h1.npz", tokens=_tokens(2, H1_VOCAB),
             **{f"p/{n}": v for n, v in named.items()})
    p, x = _moe_inputs()
    np.savez(work / "moe.npz", x=x, **{f"p/{n}": v for n, v in p.items()})
    np.savez(work / "optim.npz", **_optim_inputs())
    with ProcSet(str(work / "logs")) as procs:
        ranks = [procs.spawn(f"rank{r}", [sys.executable, WORKER, str(r), str(WORLD), str(work)])
                 for r in range(WORLD)]
        assert "JAX_MESH_OK" in run_py(f"WORK = {str(work)!r}\n" + _JAX_MESH_SIDE, devices=WORLD, deadline=DEADLINE)
        for rank in ranks:
            assert rank.wait(deadline=DEADLINE) == 0, procs.failure_report()
    outs = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    infos = []
    for r in range(WORLD):
        with open(work / f"rank{r}.json") as fh:
            infos.append(json.load(fh))
    return outs, infos, dict(np.load(work / "jax_mesh.npz"))


# -- (1) the sharded step against the one-device steps ----------------------------------


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


class _JaxGradsToo:
    """A JAX optimizer whose update also returns the gradients the step
    hands it: ``((new params, grads), new state)``."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        new, state = self.opt.update(grads, state, params)
        return (new, grads), state


@functools.lru_cache(maxsize=None)
def _one_device_step(name, reference):
    """``(loss, params by name, grads by name)`` of one step on one
    device: the port's or the JAX package's, from the case's weights and
    tokens."""
    case = CASES[name]
    named = _weights(case["arch"])
    batch = _batch(case)
    if reference == "port":
        cfg = _cfg(case)
        params = from_numpy(named, "cpu")
        opt = Recording(AdamW(lr=LR, weight_decay=0.0))
        model = build_model(cfg)
        step = (make_grpo_step(model, cfg, opt) if case.get("grpo")
                else make_train_step(model, cfg, opt, accum=case.get("accum", 1)))
        tb = {k: torch.from_numpy(v).long() if k in ("tokens", "targets") else torch.from_numpy(v)
              for k, v in batch.items()}
        _, _, metrics = step(params, opt.init(params), tb)
        return (float(metrics["loss"]), {n: t.numpy() for n, t in params.items()},
                {n: g.numpy() for n, g in opt.grads.items()})
    cfg = _jax_cfg(case)
    jm = jax_build_model(cfg)
    tree = _jax_tree(jm, named)
    opt = _JaxGradsToo(JaxAdamW(lr=LR, weight_decay=0.0))
    step = (jax_make_grpo_step(jm, cfg, opt) if case.get("grpo")
            else jax_make_train_step(jm, cfg, opt, accum=case.get("accum", 1)))
    (new, grads), _, metrics = jax.jit(step)(tree, opt.init(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(metrics["loss"]), {k: np.asarray(v) for k, v in named_tensors(new).items()},
            {k: np.asarray(v) for k, v in named_tensors(grads).items()})


@pytest.mark.parametrize("reference", ["port", "jax"])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_equals_the_one_device_step(gloo_run, name, reference):
    outs, infos, _ = gloo_run
    loss, want, _ = _one_device_step(name, reference)
    for rank in range(WORLD):
        np.testing.assert_allclose(outs[rank][f"step/{name}/loss"], loss, rtol=LOSS_RTOL)
        assert infos[rank][f"step/{name}/moment_placements_match"] is True
    got = {n[len(f"step/{name}/p/"):]: v for n, v in outs[0].items() if n.startswith(f"step/{name}/p/")}
    assert set(got) == set(want)
    worst = max(float(np.abs(got[n] - want[n]).max()) for n in want)
    moved = max(float(np.abs(got[n] - _weights(CASES[name]["arch"])[n]).max()) for n in want)
    assert worst < PARAM_TOL and moved >= LR / 2, (worst, moved)  # and the step moved them (Adam's first: ~lr)


@pytest.mark.parametrize("reference", ["port", "jax"])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_gradients_equal_the_one_device_gradients(gloo_run, name, reference):
    """The gradients the sharded step hands AdamW (placed like their
    parameters, gathered whole) equal the one-device step's, a tensor at a
    time, on every rank: the check the parameters after AdamW's first step
    cannot make."""
    outs, _, _ = gloo_run
    *_, want = _one_device_step(name, reference)
    for rank in range(WORLD):
        got = {n[len(f"step/{name}/g/"):]: v for n, v in outs[rank].items() if n.startswith(f"step/{name}/g/")}
        assert set(got) == set(want)
        for n, w in want.items():
            assert np.linalg.norm(w) > 0, n
            assert _rel_l2(got[n], w) <= GRAD_TOL, (rank, n, _rel_l2(got[n], w))


# -- (2) H1 over the mesh ------------------------------------------------------------------


def _h1_references(jax_mesh):
    named = _weights("llama3-8b", (8, 2))
    tokens = _tokens(2, H1_VOCAB)
    cfg = _jax_cfg(H1_CASE)
    jm = jax_build_model(cfg)
    with torch.no_grad():
        port = build_model(_cfg(H1_CASE)).forward(from_numpy(named, "cpu"), {"tokens": torch.from_numpy(tokens).long()})
    return {"port_plain": port.numpy(),
            "jax_plain": np.asarray(jm.forward(_jax_tree(jm, named), {"tokens": jnp.asarray(tokens)})),
            "jax_h1": jax_mesh["h1_logits"]}


@pytest.mark.parametrize("reference", ["port_plain", "jax_plain", "jax_h1"])
def test_h1_forward_matches(gloo_run, reference):
    outs, infos, jax_mesh = gloo_run
    want = _h1_references(jax_mesh)[reference]
    cfg = _cfg(H1_CASE)
    hd = cfg.resolved_head_dim
    block = [8 // 2, cfg.num_heads // 4, 16, hd]  # [B/dp, H/tp, S, hd]: K/V broadcast to the query heads
    for rank in range(WORLD):
        np.testing.assert_allclose(outs[rank]["h1/logits"], want, rtol=H1_TOL, atol=H1_TOL)
        assert infos[rank]["h1_local_shapes"] == [[block, block, block]]


# -- (3) H3's backward -----------------------------------------------------------------------


def _dense_ref_grads():
    p, x = _moe_inputs()
    cfg = _cfg({"arch": "dbrx-132b"})
    leaves = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    xl = torch.from_numpy(x).requires_grad_()
    grads = torch.autograd.grad((blocks.moe_dense_ref(cfg, leaves, xl) ** 2).sum(), [*leaves.values(), xl])
    return {n: g.numpy() for n, g in zip([*leaves, "x"], grads)}


@pytest.mark.parametrize("reference", ["dense_ref", "jax_h3"])
@pytest.mark.parametrize("form", ["plain", "train"])
def test_h3_gradients_match(gloo_run, form, reference):
    outs, infos, jax_mesh = gloo_run
    want = _dense_ref_grads() if reference == "dense_ref" else {n[3:]: v for n, v in jax_mesh.items()
                                                                  if n.startswith("h3/")}
    assert set(want) == {"ln", "router", "w_gate", "w_up", "w_down", "x"}
    for rank in range(WORLD):
        for n, w in want.items():
            assert _rel_l2(outs[rank][f"h3/{form}/{n}"], w) <= H3_TOL, (rank, n)
    if form == "train":  # the gradients come back placed as their tensors are
        assert all(p != "plain" for p in infos[0]["h3_train_grad_placements"])


# -- (4) the optimizer on DTensors -------------------------------------------------------------


@pytest.mark.parametrize("what", ["global_norm", "adamw_clip", "adamw_no_clip"])
def test_optimizer_on_dtensors_is_bit_equal(gloo_run, what):
    outs, infos, _ = gloo_run
    for rank in range(WORLD):
        if what == "global_norm":
            assert outs[rank]["optim/norm_dtensor"] == outs[rank]["optim/norm_plain"]
            assert outs[rank]["optim/norm_plain"] == outs[0]["optim/norm_plain"]
            assert infos[rank]["optim_init_placed_like_params"] is True
        else:
            label = what[len("adamw_"):]
            assert infos[rank][f"optim_{label}_bit_equal"] is True
            assert infos[rank][f"optim_{label}_steps"] == [1, 1]


# -- the families without a sharded path ---------------------------------------------------


@pytest.fixture()
def smoke_mesh():
    import torch.distributed as dist

    from repro_torch.launch import make_smoke_mesh

    mesh = make_smoke_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,family", [("zamba2-2.7b", "hybrid"), ("xlstm-350m", "ssm")])
def test_other_families_refuse_dtensor_parameters_by_name(smoke_mesh, arch, family):
    """The hybrid and the xLSTM refuse DTensor parameters by name, in the
    forward and so in the step; with plain parameters they run as before."""
    from repro_torch.models.params import init_params
    from repro_torch.sharding import TRAIN_RULES, place_tree

    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    placed = place_tree(params, dict(decoder_specs(cfg)), TRAIN_RULES, smoke_mesh)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8))}
    model = build_model(cfg)
    with pytest.raises(NotImplementedError, match=rf"{cfg.name} \({family} family.*the sharded serving and train steps"):
        model.forward(placed, batch)
    with pytest.raises(NotImplementedError, match="the sharded serving and train steps"):
        opt = AdamW()
        make_train_step(model, cfg, opt)(placed, opt.init(placed), batch)
    assert torch.isfinite(model.forward(params, batch)).all()
