"""The port's optimisation flags (``models/optim.py``) against the JAX
package's, on the CPU.

H2 (``lowp_norm``): ``rms_norm`` matches the JAX H2 norm at 2e-2 in bf16,
is bit-equal with the flag on or off in f32, and differs from the flag-off
result in bf16 (the flag is live); the bf16 forward of six reduced archs
(llama3-8b, dbrx-132b, deepseek-v3-671b, hubert-xlarge, zamba2-2.7b,
xlstm-350m) under ``optimizations(lowp_norm=True)`` matches the JAX forward
under the JAX ``optimizations(lowp_norm=True)`` at 2e-2 of the max |logit|
(or, where bf16's own rounding is wider, within the JAX bf16 forward's own
distance from the f32 forward of the same weights), on the JAX weights
carried across with ``from_numpy``. A MoE arch's port forward follows the
JAX forward's experts (``route(..., experts=)``, as ``chip_smoke.py``'s
replays do): at random init a few tokens' router probabilities tie to
within bf16's rounding, and the two packages' roundings send them to other
experts (ROADMAP's hazards). The flags nest and restore; H1 runs with a
mesh description (K/V broadcast to the query heads).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import optim as jax_optim  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402

import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.launch import MeshShape  # noqa: E402
from repro_torch.models import blocks, build_model, optim  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.kernels.flash_attention import attention_plain  # noqa: E402
from repro_torch.models.params import from_numpy, init_params  # noqa: E402

BF16_TOL = 2e-2
H2_ARCHS = ("llama3-8b", "dbrx-132b", "deepseek-v3-671b", "hubert-xlarge", "zamba2-2.7b", "xlstm-350m")


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _norm_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 4.0)).astype(np.float32)
    gamma = (rng.standard_normal(shape[-1]) * 0.3).astype(np.float32)
    return x, gamma


@pytest.mark.parametrize("seed,shape", [(0, (4, 64)), (1, (2, 7, 256)), (2, (3, 1280)), (3, (1, 5, 4096))])
def test_h2_norm_matches_jax_h2_in_bf16(seed, shape):
    x, gamma = _norm_inputs(seed, shape)
    with jax_optim.optimizations(lowp_norm=True):
        want = jax_layers.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma, jnp.bfloat16))
    with optim.optimizations(lowp_norm=True):
        got = rms_norm(_bf16(x), _bf16(gamma))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_h2_leaves_f32_bit_equal(seed):
    x, gamma = _norm_inputs(seed, (3, 9, 128))
    off = rms_norm(torch.from_numpy(x), torch.from_numpy(gamma))
    with optim.optimizations(lowp_norm=True):
        on = rms_norm(torch.from_numpy(x), torch.from_numpy(gamma))
    assert torch.equal(on, off)


def test_h2_is_live_in_bf16():
    x, gamma = _norm_inputs(5, (8, 512))
    off = rms_norm(_bf16(x), _bf16(gamma))
    with optim.optimizations(lowp_norm=True):
        on = rms_norm(_bf16(x), _bf16(gamma))
    # H2 scales in bf16: the result is its own arithmetic, bit for bit
    xb = _bf16(x)
    scale = torch.rsqrt(xb.float().square().mean(-1, keepdim=True) + 1e-6)
    assert torch.equal(on, xb * scale.to(torch.bfloat16) * (1.0 + _bf16(gamma).float()).to(torch.bfloat16))
    assert not torch.equal(on, off)
    assert (on.float() - off.float()).abs().max() <= BF16_TOL * off.float().abs().max()


def test_flags_nest_and_restore():
    assert optim.FLAGS == optim.OptFlags() and not optim.broadcast_kv_active()
    with optim.optimizations(lowp_norm=True) as outer:
        assert optim.FLAGS is outer and outer.lowp_norm
        with optim.optimizations(shardmap_moe=True, model_axis="tp"):
            assert optim.FLAGS.lowp_norm and optim.FLAGS.shardmap_moe and optim.FLAGS.model_axis == "tp"
        assert not optim.FLAGS.shardmap_moe and optim.FLAGS.model_axis == "model"
    assert optim.FLAGS == optim.OptFlags()
    with pytest.raises(RuntimeError), optim.optimizations(lowp_norm=True):
        raise RuntimeError("restored on the way out")
    assert optim.FLAGS == optim.OptFlags()


def test_h1_with_a_mesh_is_refused():
    """H1 with a mesh description (``MeshShape``) runs: K/V are broadcast to
    the query heads (the attention sees 8 KV heads where the config has 2),
    plain tensors are not moved by ``shard_attn``, and the logits equal the
    flag-off forward's. Without a mesh H1 is the JAX package's identity."""
    x = torch.ones(2, 4, 3, 8)
    with optim.optimizations(shard_attn_heads=True):  # no mesh: the JAX package's identity
        assert optim.shard_attn(x) is x and not optim.broadcast_kv_active()
    cfg = dataclasses.replace(port_configs.get_config("llama3-8b").reduced(), num_heads=8, num_kv_heads=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)))
    heads = []

    def attention(q, k, v, **kw):
        heads.append((q.shape[1], k.shape[1], v.shape[1]))
        return attention_plain(q, k, v, **kw)

    model = build_model(cfg, attention=attention)
    with torch.no_grad():
        off = model.forward(params, {"tokens": tokens})
        with optim.optimizations(shard_attn_heads=True, mesh=MeshShape((2, 4), ("data", "model"))):
            assert optim.broadcast_kv_active() and optim.shard_attn(x) is x
            on = model.forward(params, {"tokens": tokens})
    assert heads == [(8, 2, 2)] * cfg.num_layers + [(8, 8, 8)] * cfg.num_layers
    torch.testing.assert_close(on, off, rtol=1e-5, atol=1e-5)
    assert optim.FLAGS == optim.OptFlags()


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.encoder_only:
        return {"frames": rng.standard_normal((2, 16, cfg.frontend_dim)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)}


def _pin_routes(monkeypatch):
    """Record every JAX ``top_k``'s indices in order (the MoE router's,
    once a MoE layer) and make the port's ``route`` take them in the same
    order, from the first again once it took them all. Returns the recorded
    and the taken lists."""
    seen, taken = [], []
    top_k = jax.lax.top_k

    def recording(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx, ordered=True)
        return vals, idx

    route = blocks.route

    def pinned(cfg, p, flat, experts=None):
        experts = torch.from_numpy(seen[len(taken) % len(seen)].reshape(flat.shape[0], -1)).long()
        taken.append(experts)
        return route(cfg, p, flat, experts=experts)

    monkeypatch.setattr(jax.lax, "top_k", recording)
    monkeypatch.setattr(blocks, "route", pinned)
    return seen, taken


@pytest.mark.parametrize("arch", H2_ARCHS)
def test_h2_forward_matches_jax_h2_forward_in_bf16(arch, monkeypatch):
    jcfg, pcfg = jax_configs.get_config(arch).reduced(), port_configs.get_config(arch).reduced()
    jm = jax_build_model(jcfg)
    template = jm.init(jax.random.PRNGKey(0), jnp.float32)
    named = {k: np.asarray(v) for k, v in named_tensors(template).items()}
    rng = np.random.default_rng(11)
    for k in named:  # the norms drawn away from zero, so ``1 + gamma`` is exercised
        if k.rsplit("/", 1)[-1] in ("ln", "post_ln", "q_ln", "kv_ln", "final_ln", "norm"):
            named[k] = (rng.standard_normal(named[k].shape) * 0.2).astype(np.float32)
    jp = jax.tree.unflatten(jax.tree.structure(template),
                            [jnp.asarray(named[k], jnp.bfloat16) for k in named_tensors(template)])
    pp = {k: v.to(torch.bfloat16) for k, v in from_numpy(named, "cpu").items()}
    batch = _inputs(pcfg, 3)
    if pcfg.moe is not None:
        seen, taken = _pin_routes(monkeypatch)
    with jax_optim.optimizations(lowp_norm=True):
        want = jax.jit(lambda p, b: jm.forward(p, b))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    pm = build_model(pcfg)
    pbatch = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        with optim.optimizations(lowp_norm=True):
            got = pm.forward(pp, pbatch)
        exact = pm.forward({k: v.float() for k, v in pp.items()}, pbatch).numpy()  # the same weights in f32
    want = np.asarray(want, np.float32)
    if pcfg.moe is not None:
        assert len(seen) == pcfg.num_layers - pcfg.moe.first_dense and len(taken) == 2 * len(seen)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    scale = np.abs(want).max()
    err, floor = np.abs(got.float().numpy() - want).max() / scale, np.abs(exact - want).max() / scale
    print(f"{arch}: port vs JAX {err:.4f}, JAX bf16 vs f32 {floor:.4f} of the max |logit|")  # shown with -s
    assert err <= max(BF16_TOL, floor), (arch, err, floor)
