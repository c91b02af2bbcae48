"""The hybrid family (zamba2-2.7b) in the port against the JAX package, on
the CPU.

zamba2-2.7b's ``reduced()`` (4 layers in 2 groups of 2 Mamba2 blocks, each
group followed by the shared attention block; d_model 64, 4 heads of 16,
SSD heads of 16, state 16, chunk 16, window 8) in f32, and the same at
head_dim 80 (d_model 160, 2 heads of 80: the published head_dim, whose
attention runs on the card's head_dim-80 kernels). The JAX ``HybridLM``'s
parameters are carried across with ``from_numpy``, the norms, ``conv_b``,
``a_log``, ``dt_bias`` and ``d_skip`` drawn away from their init values so
every term is exercised. Tolerances: 2e-5 in f32, 2e-2 with bf16 weights
(``tests/test_torch_hybrid_train.py`` holds the training steps).

The SSD pieces are held one by one: ``_ssd_chunked`` against the JAX one
and against ``ssd_reference`` (the step-by-step oracle) for sequences
below, equal to and not a multiple of the chunk, with and without an
initial state; ``_causal_conv``; ``ssd_block_apply`` without a cache (a
sequence shorter than the conv too), with a one-token cache and with a
chunk behind a cache. At the published chunk of 256 the JAX chunked
scan's gradient with respect to the pre-softplus dt is NaN (its exponent
overflows above the diagonal before the mask); the port's is finite and
equals the gradient of ``ssd_reference``: the port's copy of it at 256
steps (``jax.grad`` of the JAX one at 256 steps is slow on the CPU, eager
and under ``jit`` alike: each step is a Python loop iteration), whose
forward and gradient are held to the JAX ``ssd_reference``'s at 12 steps.

The JAX model runs under ``jax.jit`` (its eager ``lax.scan`` compiles its
body on every call). With bf16 weights the logits are held to 2e-2 as a
relative L2 error (``|got - want| / |want|`` over a step's logits): the two
packages' bf16 SiLU round differently (torch computes it in f32 and
rounds once, JAX rounds the sigmoid to bf16 first), and the one-ulp
differences in the shared MLP's activations move a few small logits by
more than 2e-2 of their own size.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import meta as jax_meta  # noqa: E402
from repro.models import ssd as jax_ssd  # noqa: E402
from repro.models.layers import reference_attention  # noqa: E402
from repro.models.lm import HybridLM as JaxHybrid  # noqa: E402
from repro.models.lm import _ring_attention_step as jax_ring_step  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402

import test_torch_moe_interop as interop  # noqa: E402  (its replica scenario, run here on the hybrid)
import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import meta as port_meta  # noqa: E402
from repro_torch.data.synthetic import PromptSet  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as serve_main  # noqa: E402
from repro_torch.models import build_model, check_ported, check_trainable, ssd  # noqa: E402
from repro_torch.models.lm import DecoderLM, HybridLM, _ring_attention_step  # noqa: E402
from repro_torch.models.params import decoder_shapes, from_numpy, init_params  # noqa: E402
from repro_torch.rl.loop import RLConfig, RolloutWorker, sample_responses  # noqa: E402
from repro_torch.training import steps as psteps  # noqa: E402

ARCH = "zamba2-2.7b"
TOL = LOSS_TOL = 2e-5
BF16_TOL = 2e-2
#: the reduced config as it stands (head_dim 16), and at the published head_dim 80
VARIANTS = {"reduced": {}, "head_dim_80": {"d_model": 160, "num_heads": 2, "num_kv_heads": 2, "head_dim": 80}}
#: the SSD parameters drawn away from their init values (zeros or ones), with their scale
_MOVED = {"ln": 0.1, "norm": 0.1, "conv_b": 0.1, "a_log": 0.3, "dt_bias": 0.3, "d_skip": 0.1}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _jax_tree(jm, named, dtype=jnp.float32):
    template = jm.init(jax.random.PRNGKey(0), jnp.float32)
    return jax.tree.unflatten(jax.tree.structure(template),
                              [jnp.asarray(named[k]).astype(dtype) for k in named_tensors(template)])


def _jax_params(jcfg, seed: int = 0):
    """The JAX ``HybridLM``'s parameters as numpy by name, the tensors of
    ``_MOVED`` drawn away from their init values, and the JAX tree
    holding them."""
    jm = JaxHybrid(jcfg)
    named = {k: np.asarray(v) for k, v in named_tensors(jm.init(jax.random.PRNGKey(seed), jnp.float32)).items()}
    rng = np.random.default_rng(7)
    for k in named:
        leaf = k.rsplit("/", 1)[-1]
        if leaf in _MOVED or leaf == "final_ln":
            named[k] = (named[k] + rng.standard_normal(named[k].shape) * _MOVED.get(leaf, 0.1)).astype(np.float32)
    return jm, _jax_tree(jm, named), named


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jcfg, pcfg = _cfgs(request.param)
    jm, jp, named = _jax_params(jcfg)
    return jcfg, pcfg, jm, jp, named, build_model(pcfg), from_numpy(named, "cpu")


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


_JITTED = {}


def _jit(jm, name):
    """``jm``'s method ``name`` under ``jax.jit`` (``max_len`` and ``ring``
    static), one per model and method."""
    key = (id(jm), name)
    if key not in _JITTED:
        static = {"prefill": ("max_len",), "decode": ("ring",), "init_cache": ()}.get(name, ())
        _JITTED[key] = (jm, jax.jit(getattr(jm, name), static_argnames=static))
    return _JITTED[key][1]


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _caches_close(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for part in want:
        assert got[part].keys() == want[part].keys()
        for n in want[part]:
            assert tuple(got[part][n].shape) == tuple(want[part][n].shape), (part, n)
            _close(got[part][n], np.asarray(want[part][n], np.float32), tol)


# -- the config -------------------------------------------------------------------


def test_reduced_and_full_configs_are_the_hybrid_family():
    jcfg, pcfg = _cfgs("head_dim_80")
    assert pcfg.family == jcfg.family == "hybrid" and pcfg.resolved_head_dim == 80
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.resolved_head_dim, full.d_ff,
            full.vocab, full.sliding_window, full.attn_softcap) == (54, 2560, 32, 32, 80, 10240, 32000, 4096, 0.0)
    assert dataclasses.astuple(full.ssm) == (64, 4, 2, 64, 256, 6)
    assert ssd.ssd_dims(full) == (5120, 80, 64, 64, 5248)
    assert full.param_count() == 2_421_923_840
    model = build_model(full)
    assert isinstance(model, HybridLM) and (model.groups, model.every) == (9, 6)
    red = get_config(ARCH).reduced()
    assert (red.num_layers, red.ssm.shared_block_every, red.ssm.chunk, red.sliding_window) == (4, 2, 16, 8)


def test_softplus_is_jaxs_at_every_x():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` everywhere; torch's
    ``softplus`` returns x itself above its threshold of 20 (a difference of
    ~2e-9 there, but the port keeps the exact form)."""
    x = np.concatenate([np.linspace(-40, 40, 4001), [-100.0, 19.9, 20.0, 20.1, 88.0, 100.0]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ssd.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.array_equal(got[x > 20.5], want[x > 20.5])


# -- the SSD pieces -----------------------------------------------------------------


def _ssd_inputs(seed, b, t, h, p, n, *, scale_dt=1.0, a=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt_raw = (rng.standard_normal((b, t, h)) * scale_dt).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32) if a is None else np.full(h, a, np.float32)
    bmat = rng.standard_normal((b, t, n)).astype(np.float32)
    cmat = rng.standard_normal((b, t, n)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    return x, dt_raw, a, bmat, cmat, s0


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize("t", [5, 16, 37], ids=["below_chunk", "one_chunk", "not_a_multiple"])
def test_ssd_chunked_matches_jax_and_the_recurrence(t, init):
    x, dt_raw, a, bm, cm, s0 = _ssd_inputs(t, 2, t, 3, 4, 8)
    dt = np.array(jax.nn.softplus(jnp.asarray(dt_raw)))
    init_j = jnp.asarray(s0) if init else None
    init_p = torch.from_numpy(s0) if init else None
    y_j, s_j = jax_ssd._ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), 16, init_j)
    y_r, s_r = jax_ssd.ssd_reference(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), init_j)
    args = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    y_p, s_p = ssd._ssd_chunked(*args, 16, init_p)
    y_pr, s_pr = ssd.ssd_reference(*args, init_p)
    assert y_p.shape == (2, t, 3, 4) and s_p.shape == (2, 3, 4, 8) and s_p.dtype == torch.float32
    for got, want in ((y_p, y_j), (s_p, s_j), (y_p, y_r), (s_p, s_r), (y_pr, y_r), (s_pr, s_r)):
        _close(got, want)


@pytest.mark.parametrize("t", [1, 2, 9])
def test_causal_conv_matches_jax(t):
    rng = np.random.default_rng(t)
    xbc = rng.standard_normal((2, t, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) * 0.5
    b = rng.standard_normal(24).astype(np.float32) * 0.1
    want = jax_ssd._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b))
    _close(ssd._causal_conv(*(torch.from_numpy(v) for v in (xbc, w, b))), want)


#: ssd_block_apply's cases: (the cache's length before the call, or None for
#: no cache, and the call's tokens)
BLOCK_CASES = {"no_cache": (None, 9), "no_cache_shorter_than_the_conv": (None, 2), "one_token": (7, 1),
               "chunk_behind_a_cache": (7, 5), "chunks_behind_a_cache": (3, 21)}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_ssd_block_apply_matches_jax(case):
    """One block of the reduced config (its first) against the JAX block
    under ``jit``: the output and the new cache (conv rows, state). The
    cached cases run from the cache a cacheless call of ``prefix`` tokens
    left."""
    jcfg, pcfg = _cfgs("reduced")
    _, _, named = _jax_params(jcfg)
    block = jax.jit(lambda p, x, cache: jax_ssd.ssd_block_apply(jcfg, p, x, cache=cache))
    prefix, seq = BLOCK_CASES[case]
    lp = {k.split("/")[1]: v[0, 0] for k, v in named.items() if k.startswith("groups/")}
    x = np.random.default_rng(3).standard_normal((2, (prefix or 0) + seq, pcfg.d_model)).astype(np.float32)
    jp = {n: jnp.asarray(v) for n, v in lp.items()}
    pp = {n: torch.from_numpy(v.copy()) for n, v in lp.items()}
    jcache = pcache = None
    if prefix is not None:
        _, jcache = block(jp, jnp.asarray(x[:, :prefix]), None)
        _, pcache = ssd.ssd_block_apply(pcfg, pp, torch.from_numpy(x[:, :prefix]))
        _caches_close({"c": pcache}, {"c": jcache})
    xs = x[:, (prefix or 0):]
    want, want_c = block(jp, jnp.asarray(xs), jcache)
    got, got_c = ssd.ssd_block_apply(pcfg, pp, torch.from_numpy(xs), cache=pcache)
    _close(got, want)
    k = pcfg.ssm.d_conv
    assert got_c["conv"].shape == (2, k - 1, ssd.ssd_dims(pcfg)[4])
    _caches_close({"c": got_c}, {"c": want_c})
    if case == "no_cache_shorter_than_the_conv":  # left-padded with zeros
        assert not got_c["conv"][:, : k - 1 - seq].any()


def test_ssd_block_keeps_jaxs_dtypes():
    """bf16 activations: the output and the conv rows in bf16 (the rows an
    f32 cache holds promote the window to f32, as JAX's type promotion does),
    the state f32; against the JAX block within the bf16 tolerance (one
    block's outputs are in fact bit-equal)."""
    jcfg, pcfg = _cfgs("reduced")
    _, _, named = _jax_params(jcfg)
    lp = {k.split("/")[1]: v[0, 1] for k, v in named.items() if k.startswith("groups/")}
    jp = {n: jnp.asarray(v).astype(jnp.bfloat16) for n, v in lp.items()}
    pp = {n: torch.from_numpy(v).to(torch.bfloat16) for n, v in lp.items()}
    x = np.random.default_rng(4).standard_normal((2, 6, pcfg.d_model)).astype(np.float32)
    block = jax.jit(lambda p, x, cache: jax_ssd.ssd_block_apply(jcfg, p, x, cache=cache))
    out, c = ssd.ssd_block_apply(pcfg, pp, torch.from_numpy(x).to(torch.bfloat16))
    jout, jc = block(jp, jnp.asarray(x).astype(jnp.bfloat16), None)
    assert out.dtype == c["conv"].dtype == torch.bfloat16 and c["state"].dtype == torch.float32
    _close(out, jout, BF16_TOL)
    assert np.array_equal(_np(out), np.asarray(jout, np.float32))  # the same roundings at the same places
    f32 = {"conv": torch.zeros_like(c["conv"], dtype=torch.float32), "state": c["state"]}
    step = torch.from_numpy(x[:, :1]).to(torch.bfloat16)
    out1, c1 = ssd.ssd_block_apply(pcfg, pp, step, cache=f32)
    jout1, jc1 = block(jp, jnp.asarray(x[:, :1]).astype(jnp.bfloat16),
                       {"conv": jnp.zeros(f32["conv"].shape, jnp.float32), "state": jnp.asarray(c["state"].numpy())})
    assert out1.dtype == torch.bfloat16 and c1["conv"].dtype == torch.float32 and jc1["conv"].dtype == jnp.float32
    _close(out1, jout1, BF16_TOL)
    _close(c1["state"], jc1["state"], BF16_TOL)


def _dt_grad(fn, x, dt_raw, a, bm, cm):
    """The gradient of ``fn(x, softplus(dt_raw), a, B, C)[0].sum()`` with
    respect to the pre-softplus ``dt_raw``, through torch's autograd."""
    d = torch.from_numpy(dt_raw).requires_grad_()
    y, _ = fn(torch.from_numpy(x), ssd.softplus(d), *(torch.from_numpy(v) for v in (a, bm, cm)))
    (g,) = torch.autograd.grad(y.sum(), d)
    return g.numpy()


def test_ssd_gradient_at_chunk_256_is_finite_and_the_recurrences():
    """b, t, h, p, n = 1, 256, 2, 4, 8 at the init values (dt = softplus(~0),
    a = -1) and chunk 256: ``jax.grad`` of the JAX chunked scan with respect
    to the pre-softplus dt is NaN at every element (its exponent overflows
    above the diagonal, and the mask after the exp multiplies a zero
    cotangent by inf), and finite at chunks 16, 64 and 128; the port's
    masks the exponent first, so its gradient
    is finite and equals the gradient of ``ssd_reference`` (the port's, see
    the next test) within 1e-4 of its max |value|."""
    x, dt_raw, a, bm, cm, _ = _ssd_inputs(0, 1, 256, 2, 4, 8, scale_dt=0.1, a=-1.0)
    xj, aj, bj, cj = (jnp.asarray(v) for v in (x, a, bm, cm))
    def jax_chunked_grad(chunk):
        return np.asarray(jax.jit(jax.grad(lambda d: jax_ssd._ssd_chunked(xj, jax.nn.softplus(d), aj, bj, cj, chunk)[0]
                                           .sum()))(jnp.asarray(dt_raw)))

    chunked = jax_chunked_grad(256)
    assert np.isnan(chunked).all() and chunked.size == 512
    for chunk in (16, 64, 128):  # shorter chunks keep the exponent below f32's range
        assert np.isfinite(jax_chunked_grad(chunk)).all(), chunk
    ref = _dt_grad(ssd.ssd_reference, x, dt_raw, a, bm, cm)
    got = _dt_grad(lambda *v: ssd._ssd_chunked(*v, 256), x, dt_raw, a, bm, cm)
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    assert float(np.max(np.abs(got - ref))) <= 1e-4 * float(np.max(np.abs(ref)))
    # the JAX formula (exp over the whole chunk, the mask after it) in torch
    # gives the same NaNs: the overflow is the formula's, not JAX's
    cum = torch.cumsum(torch.full((256,), -0.69), 0)
    assert bool(torch.isinf(torch.exp(cum[:, None] - cum[None, :])).any())


def test_ssd_reference_is_jaxs():
    """The port's ``ssd_reference`` (the yardstick above) against the JAX
    one at 12 steps: the outputs, the final state, and the gradient with
    respect to the pre-softplus dt (``jax.grad``)."""
    x, dt_raw, a, bm, cm, _ = _ssd_inputs(1, 1, 12, 2, 4, 8, scale_dt=0.5)
    xj, aj, bj, cj = (jnp.asarray(v) for v in (x, a, bm, cm))
    y_j, s_j = jax_ssd.ssd_reference(xj, jax.nn.softplus(jnp.asarray(dt_raw)), aj, bj, cj)
    y_p, s_p = ssd.ssd_reference(*(torch.from_numpy(v) for v in (x, np.array(jax.nn.softplus(dt_raw)), a, bm, cm)))
    _close(y_p, y_j)
    _close(s_p, s_j)
    want = np.asarray(jax.grad(lambda d: jax_ssd.ssd_reference(xj, jax.nn.softplus(d), aj, bj, cj)[0].sum())(
        jnp.asarray(dt_raw)))
    got = _dt_grad(ssd.ssd_reference, x, dt_raw, a, bm, cm)
    assert float(np.max(np.abs(got - want))) <= 1e-4 * float(np.max(np.abs(want)))


# -- the model ------------------------------------------------------------------------


@pytest.mark.parametrize("s", [7, 37])
def test_forward_matches_jax(model, s):
    jcfg, pcfg, jm, jp, _, pm, pp = model
    toks = _tokens(pcfg, s, 2, s)
    want = _jit(jm, "forward")(jp, {"tokens": jnp.asarray(toks)})
    got = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, s, pcfg.vocab) and got.dtype == torch.float32
    _close(got, want)


def test_prefill_matches_jax(model):
    """The last position's logits and every cache entry: the conv rows and
    states of all 4 blocks, the shared block's K/V padded to ``max_len``."""
    jcfg, pcfg, jm, jp, _, pm, pp = model
    toks = _tokens(pcfg, 21, 2, 19)
    jl, jc, jn = _jit(jm, "prefill")(jp, {"tokens": jnp.asarray(toks)}, max_len=25)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, max_len=25)
    assert pn == int(jn) == 19 and pl.shape == (2, 1, pcfg.vocab)
    _close(pl, jl)
    _caches_close(pc, jc)
    assert pc["attn"]["k"].shape == (2, 2, pcfg.num_kv_heads, 25, pcfg.resolved_head_dim)


@pytest.mark.parametrize("chunk", [1, 3], ids=["one_token_steps", "three_token_steps"])
def test_decode_chain_matches_jax(model, chunk):
    """Prefill 10 tokens into 28 slots, then 6 decode calls of ``chunk``
    tokens each (one step of the recurrence, or the chunked scan from the
    cached state): every call's logits and the final caches."""
    jcfg, pcfg, jm, jp, _, pm, pp = model
    toks = _tokens(pcfg, 5, 2, 10 + 6 * chunk)
    jl, jc, n = _jit(jm, "prefill")(jp, {"tokens": jnp.asarray(toks[:, :10])}, max_len=28)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :10]).long()}, max_len=28)
    for i in range(6):
        t = toks[:, 10 + i * chunk : 10 + (i + 1) * chunk]
        jl, jc = _jit(jm, "decode")(jp, jc, jnp.asarray(t), jnp.int32(10 + i * chunk))
        pl, pc = pm.decode(pp, pc, torch.from_numpy(t).long(), pn + i * chunk)
        assert pl.shape == (2, chunk, pcfg.vocab)
        _close(pl, jl)
    _caches_close(pc, jc)


#: (dtype, ring) of the decodes from ``init_cache``: the ring in f32 at both
#: configs; the ring with bf16 weights and the plain cache in f32 at the reduced one
INIT_CACHE_CASES = [("float32", True), ("bfloat16", True), ("float32", False)]


@pytest.mark.parametrize("dtype,ring", INIT_CACHE_CASES, ids=["ring_f32", "ring_bf16", "plain_cache_f32"])
def test_decode_from_init_cache_matches_jax(model, dtype, ring):
    """14 one-token steps from ``init_cache`` (every entry f32, whatever the
    weights' dtype): with ``ring`` over a ring-buffer window cache of 8
    slots, so the ring wraps after step 8, else over 14 plain slots; the
    weights in f32 or bf16 (then the bf16 queries meet the f32 cache: the
    port casts them up for the attention, JAX's f32 chunked attention does
    the same). Every step's logits and the final caches: in f32 within
    2e-5, with bf16 weights within 2e-2 relative L2 (the module's note)."""
    jcfg, pcfg, jm, _, named, pm, _ = model
    if (dtype, ring) != ("float32", True) and pcfg.resolved_head_dim == 80:
        # one config suffices here: the ring in f32 runs at both
        jcfg, pcfg = _cfgs("reduced")
        jm, _, named = _jax_params(jcfg)
        pm = build_model(pcfg)
    steps = 14
    jdt, pdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jp = _jax_tree(jm, named, jdt)
    pp = {k: t.to(pdt) for k, t in from_numpy(named, "cpu").items()}
    jc = jm.init_cache(2, steps, jdt, ring=ring)
    pc = pm.init_cache(2, steps, pdt, "cpu", ring=ring)
    assert all(t.dtype == torch.float32 for d in pc.values() for t in d.values())
    assert pc["attn"]["k"].shape[3] == (pcfg.sliding_window if ring else steps) == (8 if ring else 14)
    _caches_close(pc, jc)
    toks = _tokens(pcfg, 9, 2, steps)
    step = psteps.make_decode_step(pm, ring=ring)
    for i in range(steps):
        jl, jc = _jit(jm, "decode")(jp, jc, jnp.asarray(toks[:, i : i + 1]), jnp.int32(i), ring=ring)
        pl, pc = step(pp, pc, torch.from_numpy(toks[:, i : i + 1]).long(), i)
        if dtype == "float32":
            _close(pl, jl)
        else:
            assert _rel_l2(pl, jl) <= BF16_TOL, (i, _rel_l2(pl, jl))
    if dtype == "float32":
        _caches_close(pc, jc)
    else:  # the states and K/V the bf16 steps left, each as a whole
        for part in jc:
            for n in jc[part]:
                assert _rel_l2(pc[part][n], jc[part][n]) <= BF16_TOL, (part, n)


@pytest.mark.parametrize("cache_len", [0, 3, 7, 8, 20])
def test_ring_attention_step_is_the_jax_one(cache_len):
    """The ring step through the attention callable (``causal=False``,
    ``kv_len = min(cache_len + 1, W)``) against the JAX einsum over the whole
    ring with its position mask; the dead slots hold values the mask must
    hide. f32 and the plain attention, at head_dim 80 and GQA 2."""
    rng = np.random.default_rng(cache_len)
    w, hd = 8, 80
    q = rng.standard_normal((2, 4, 1, hd)).astype(np.float32)
    k = rng.standard_normal((2, 2, w, hd)).astype(np.float32)
    v = rng.standard_normal((2, 2, w, hd)).astype(np.float32)
    k[:, :, cache_len + 1 :] = 1e3  # slots the ring has not reached yet
    v[:, :, cache_len + 1 :] = np.nan
    want = np.asarray(jax_ring_step(jnp.asarray(q), jnp.asarray(k), jnp.asarray(np.nan_to_num(v)), cache_len, 0.0))
    calls = []

    def attention(*a, **kw):
        calls.append(kw)
        return fa.attention_plain(*a, **kw)

    got = _ring_attention_step(attention, *(torch.from_numpy(t) for t in (q, k, np.nan_to_num(v))), cache_len, 0.0)
    _close(got, want)
    assert calls == [dict(causal=False, softcap=0.0, kv_len=min(cache_len + 1, w))]
    got = fa.split_kv_plain(*(torch.from_numpy(t) for t in (q, k, v)), causal=False, kv_len=min(cache_len + 1, w))
    _close(got, want)  # the decode kernel's algorithm reads no slot past kv_len


def test_decode_step_passes_ring_only_to_the_hybrid():
    """``make_decode_step(model, ring=True)`` asks the hybrid for its ring
    cache and decodes another model as it always does; a ``TypeError``
    raised inside a model's decode is not caught (the JAX step's ``except
    TypeError`` would hide it behind a second call)."""
    seen = []

    class Other:
        def decode(self, params, cache, tokens, cache_len):
            seen.append("other")
            raise TypeError("raised inside decode")

    with pytest.raises(TypeError, match="raised inside decode"):
        psteps.make_decode_step(Other(), ring=True)(None, None, None, 0)
    assert seen == ["other"]
    hybrid = build_model(get_config(ARCH).reduced())
    hybrid.decode = lambda *a, **kw: seen.append(kw)
    psteps.make_decode_step(hybrid, ring=True)(None, None, None, 0)
    psteps.make_decode_step(hybrid)(None, None, None, 0)
    assert seen[1:] == [{"ring": True}, {}]
    assert isinstance(build_model(get_config("llama3-8b").reduced()), DecoderLM)


# -- parameters --------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_parameter_names_and_shapes_are_the_jax_param_specs(reduced):
    """The full config's names, shapes and order (54 layers; specs only,
    nothing allocated on either side) and the reduced one's, against the
    JAX ``HybridLM.param_specs()`` flattened; and the transfer units of a
    bf16 replica of them, by each package's ``build_units``."""
    got, want = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        got, want = got.reduced(), want.reduced()
    shapes = decoder_shapes(got)
    assert shapes == [(n, tuple(s.shape)) for n, s in named_tensors(JaxHybrid(want).param_specs()).items()]
    names = [n for n, _ in shapes]
    assert names[:3] == ["embed", "final_ln", "groups/a_log"] and names[-1] == "shared_mlp/w_up"
    if not reduced:
        assert dict(shapes)["groups/w_in"] == (9, 6, 2560, 2 * 5120 + 2 * 64 + 80)
        # param_count() leaves out the norms, the SSD's per-head vectors and its conv bias
        assert sum(int(np.prod(s)) for _, s in shapes) == 2_422_670_240 == got.param_count() + 746_400

    def units(meta):
        metas = [meta.TensorMeta(n, s, "bfloat16", 2 * int(np.prod(s))) for n, s in shapes]
        return [dataclasses.astuple(u) for u in meta.build_units(metas)]

    assert units(port_meta) == units(jax_meta)


def test_init_params_draws_zeros_ones_and_normals_as_the_specs_say():
    """``init_params`` follows ``ssd_specs``' init kinds: the norms,
    ``conv_b``, ``a_log`` and ``dt_bias`` zeros, ``d_skip`` ones, the rest
    normal at std ``1/sqrt(shape[-2])``."""
    cfg = get_config(ARCH).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert list(params) == [n for n, _ in decoder_shapes(cfg)]
    zeros = {n for n, t in params.items() if not t.any()}
    ones = {n for n, t in params.items() if bool((t == 1).all())}
    assert zeros == {"final_ln", "groups/ln", "groups/norm", "groups/conv_b", "groups/a_log", "groups/dt_bias",
                     "shared_attn/ln", "shared_mlp/ln"}
    assert ones == {"groups/d_skip"}
    for n in ("groups/w_in", "groups/conv_w", "groups/w_out", "shared_attn/wq", "head"):
        assert float(params[n].std()) == pytest.approx(1 / np.sqrt(params[n].shape[-2]), rel=0.15), n
    jax_init = named_tensors(JaxHybrid(jax_get_config(ARCH).reduced()).init(jax.random.PRNGKey(0), jnp.float32))
    assert {n for n, t in jax_init.items() if not np.asarray(t).any()} == zeros
    assert {n for n, t in jax_init.items() if (np.asarray(t) == 1).all()} == ones


# -- serving ------------------------------------------------------------------------------


def _jax_logprobs(jm, params, seqs, plen):
    logits = _jit(jm, "forward")(params, {"tokens": jnp.asarray(seqs)})
    lp = jax.nn.log_softmax(logits[:, plen - 1 : -1], -1)
    return np.take_along_axis(np.asarray(lp), np.asarray(seqs)[:, plen:, None], -1)[..., 0]


def _v1(named):
    """1/8 of each tensor's 256-element rows perturbed."""
    rng = np.random.default_rng(11)
    out = {}
    for k, w in named.items():
        flat = w.reshape(-1).copy()
        for r in range(0, -(-flat.size // 256), 8):
            seg = slice(r * 256, min((r + 1) * 256, flat.size))
            flat[seg] += rng.standard_normal(flat[seg].size).astype(np.float32) * 0.05
        out[k] = flat.reshape(w.shape)
    return out


def test_rollout_worker_serves_v0_then_v1():
    """At the reduced config: a publisher registers the carried-across JAX params v0; a
    ``RolloutWorker`` replicates them, samples 4 x (6 + 20) tokens (prefill,
    then 20 decode steps through the conv rows, the states and the shared
    block's K/V), updates to v1 in the same buffers and samples again;
    each round's logprobs are the JAX forward's on the sampled tokens."""
    jcfg, pcfg = _cfgs("reduced")
    jm, _, named = _jax_params(jcfg)
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
    pub = hub.open("actor", "trainer", 1, 0, datacenter="dc0")
    pub.register(from_numpy(named, "cpu"))
    pub.publish(0)
    cfg = RLConfig(prompt_len=6, response_len=20, num_prompts=2, group_size=2)
    out = []
    w = RolloutWorker("rollout-0", hub, cfg, pcfg, PromptSet(pcfg.vocab, 6), out, threading.Event())
    assert isinstance(w.model, HybridLM) and w.connect(timeout=30) == 0
    buffers = {k: t.data_ptr() for k, t in w.params.items()}
    v1 = _v1(named)
    for version, weights in ((0, named), (1, v1)):
        if version:
            pub.unpublish()
            for k, t in pub.store.tensors().items():
                t.copy_(torch.from_numpy(v1[k]))
            pub.publish(1)
            assert w.pull_latest() and w.weights_version == 1
            assert {k: t.data_ptr() for k, t in w.params.items()} == buffers
        for k in weights:
            np.testing.assert_array_equal(w.params[k].numpy(), weights[k])
        rec = w.serve_batch(version)
        assert rec["version"] == version and rec["tokens"].shape == (4, 26)
        _close(rec["behavior_logprobs"], _jax_logprobs(jm, _jax_tree(jm, weights), rec["tokens"].numpy(), 6))
    assert len(out) == 2 and not w.pull_latest()


def test_cpu_path_launches_no_kernel(model):
    _, pcfg, _, _, _, pm, pp = model
    before = fa.LAUNCHES.value
    sample_responses(pm, pp, torch.from_numpy(_tokens(pcfg, 8, 2, 4)).long(), 3, torch.Generator().manual_seed(1))
    assert fa.LAUNCHES.value == before == 0


def test_serve_answers_a_reduced_zamba2():
    rows = serve_main.serve(get_config(ARCH).reduced(), requests=2, prompt_len=6, gen_len=3, rounds=2, device="cpu",
                            dtype=torch.float32)
    assert [r["version"] for r in rows] == [0, 0] and all(r["tokens"] == 6 for r in rows)


def test_serve_entry_point_admits_all_54_layers(monkeypatch):
    """Two bf16 copies of zamba2 (the publisher's and the rollout's, 9.7 GB by
    ``param_count``)
    fit an 80 GB card: ``serve.main`` passes the published depth on."""
    monkeypatch.setattr(serve_main, "device_memory", lambda device: 80 * 10**9)
    served = []
    monkeypatch.setattr(serve_main, "serve", lambda cfg, **kw: served.append((cfg, kw)))
    serve_main.main(["--arch", ARCH, "--device", "cpu", "--requests", "8", "--prompt-len", "512", "--gen-len", "64"])
    cfg, kw = served[0]
    assert cfg.num_layers == 54 and 2 * 2 * cfg.param_count() == 9_687_695_360
    assert (kw["requests"], kw["prompt_len"], kw["gen_len"]) == (8, 512, 64)
    check_ported(cfg)
    check_trainable(cfg)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pub_name", ["jax", "port"])
def test_hybrid_replica_crosses_the_packages_bit_equal(pub_name, dtype, monkeypatch):
    """The hybrid's names (``groups/...``, ``shared_attn/...``) and unit
    schedule at the head_dim-80 widths, raw (dc0) and int8 (dc1), through a
    networked controller of the other package than the publisher's: every
    replica's bytes and every v1 manifest (units and checksums) equal the
    same scenario run through the JAX package alone."""
    monkeypatch.setattr(interop.jax_codec.Int8Codec, "_resolve_jax", lambda self: None)
    pub_pkg = interop.PACKAGES[pub_name]
    read_pkg = interop.PORT if pub_pkg is interop.JAX else interop.JAX
    jcfg, pcfg = _cfgs("head_dim_80")
    shapes = [(n, tuple(s.shape)) for n, s in named_tensors(JaxHybrid(jcfg).param_specs()).items()]
    assert shapes == decoder_shapes(pcfg)
    rng = np.random.default_rng(5)
    v0, v1 = {}, {}
    for name, shape in shapes:
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        w1 = w.reshape(-1).copy()
        w1[: w1.size // 256 * 256].reshape(-1, 256)[::8] += 0.01
        v0[name] = w.astype(interop.DTYPES[dtype])
        v1[name] = w1.reshape(shape).astype(interop.DTYPES[dtype])
    delta = pub_pkg is interop.PORT
    server = interop.jax_core.ReferenceServer()
    hub = interop.jax_core.TensorHubClient(server, chunk_bytes=interop.CHUNK)
    hs, want_v0 = interop._scenario(interop.JAX, interop.JAX, hub.open, lambda i: hub.open, v0, v1, delta)
    want = interop._final(server, hs)

    ctrl_server = read_pkg.core.ReferenceServer()
    http = read_pkg.httpd.ControlServer(read_pkg.service.ReferenceService(ctrl_server)).start()
    workers = [pkg.worker.NetWorker(wid, address=http.address, chunk_bytes=interop.CHUNK, rpc_timeout=20.0, **pkg.kw)
               for pkg, wid in ((pub_pkg, "pub"), (read_pkg, "reader0"), (read_pkg, "reader1"))]
    try:
        hs, got_v0 = interop._scenario(pub_pkg, read_pkg, workers[0].open, lambda i: workers[1 + i].open, v0, v1,
                                       delta)
        got = interop._final(ctrl_server, hs)
    finally:
        for w in workers:
            w.close()
        http.shutdown()
    assert got_v0 == want_v0 == {n: interop._bytes(a) for n, a in v0.items()}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key][0] == want[key][0], key
        assert got[key][1] == want[key][1], key
    units = got["trainer"][1][1]
    names = {n for u in units for n in (u[3] or (u[1],))}
    assert names == set(v0) and {"groups/conv_w", "groups/d_skip", "shared_attn/wq", "shared_mlp/w_up"} <= names


# -- the attention at head_dim 80 -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_zamba2_attention_routes(dtype):
    """zamba2's shared block at its published shapes (meta tensors): the
    decode step (q [8,32,1,80] against a cache of 576) and the ring step
    (4096 slots) go to ``decode`` in f32 and bf16 (f16 to ``f32``); the
    prefill (8 x 512) to ``tensor_core`` in bf16, ``f32`` otherwise; a call
    that needs a gradient never to ``decode``."""
    def meta(b, h, s, d=80):
        return torch.empty((b, h, s, d), dtype=dtype, device="meta")

    dec = "decode" if dtype != torch.float16 else "f32"
    full = "tensor_core" if dtype == torch.bfloat16 else "f32"
    assert fa._route(meta(8, 32, 1), meta(8, 32, 576)) == dec
    assert fa._route(meta(8, 32, 1), meta(8, 32, 4096)) == dec
    assert fa._route(meta(8, 32, 512), meta(8, 32, 512)) == full
    assert fa._route(meta(8, 32, 1), meta(8, 32, 576), grad=True) == full
    assert fa.split_plan(576, 8 * 32) == (256, 3)  # 768 blocks: split 9 tiles in 3


@pytest.mark.parametrize("kv_len", [1, 63, 64, 65, 200])
def test_split_kv_plain_at_head_dim_80(kv_len):
    """The decode kernel's algorithm at head_dim 80 (G 1, Sq 1, and a short
    chunk of 3 at G 2) against ``attention_plain``, causal behind a cache
    and ``causal=False`` over a
    ring, NaN in the slots past kv_len, with a softcap; and the JAX
    ``reference_attention``."""
    rng = np.random.default_rng(kv_len)
    for (hq, hkv, sq), causal in (((4, 4, 1), True), ((4, 2, 3), True), ((4, 4, 1), False)):
        sq = min(sq, kv_len)
        q = rng.standard_normal((2, hq, sq, 80)).astype(np.float32)
        k = rng.standard_normal((2, hkv, 208, 80)).astype(np.float32)
        v = rng.standard_normal((2, hkv, 208, 80)).astype(np.float32)
        k[:, :, kv_len:] = np.nan
        v[:, :, kv_len:] = np.nan
        kw = dict(causal=causal, softcap=30.0, q_offset=kv_len - sq if causal else 0, kv_len=kv_len)
        t = [torch.from_numpy(a) for a in (q, k, v)]
        got = fa.split_kv_plain(*t, keys_per_split=64, **kw)
        assert bool(torch.isfinite(got).all())
        clean = [torch.from_numpy(np.nan_to_num(a)) for a in (q, k, v)]
        _close(got, fa.attention_plain(*clean, **kw))
        want = reference_attention(*(jnp.asarray(np.nan_to_num(a)) for a in (q, k, v)), causal=causal,
                                   q_offset=kw["q_offset"], kv_len=kv_len, attn_softcap=30.0)
        _close(got, want)
