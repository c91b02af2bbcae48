"""The SSM family (xlstm-350m) in the port against the JAX package, on the
CPU.

xlstm-350m's ``reduced()`` (4 layers in 2 pairs of one mLSTM and one sLSTM
block; d_model 64, 4 heads: the mLSTM's d_in 128 and head size 32, the
sLSTM's head size 16) in f32. The JAX ``XLSTMLM``'s parameters are carried
across with ``from_numpy``, the norms and the gate biases drawn away from
zero so every term is exercised. Tolerances: 2e-5 in f32, 2e-2 relative L2
with bf16 weights (``tests/test_torch_xlstm_train.py`` holds the training
steps). The block forms are held element by element; the model's logits
and caches to 2e-5 of the compared tensor's max |value| (``_scaled_close``,
``chip_smoke.py``'s norm): the mLSTM's normaliser ``max(|q . n|, exp(-m))``
divides by small sums, so f32 rounding moves a few logits of |value| ~4 by
1-3e-5 in either package, which is as far as the JAX package's own decode
and teacher-forced forward of the same tokens sit from each other.

The block forms are held one by one against their JAX counterparts:
``_mlstm_parallel``; ``_mlstm_chunked`` at T below, equal to and not a
multiple of the chunk (``chunk=16`` on both sides, so chunks are crossed at
a small T) and at T = 300 at the default 256 (two chunks, the second
padded), with and without an initial state; ``_mlstm_step``;
``_mlstm_fold_state``; ``slstm_block_apply`` with and without a cache; one
mLSTM block at the published widths (d_model 1024, head size 512). The
three mLSTM forms agree with each other too. The JAX side runs under
``jax.jit`` (its eager ``lax.scan`` compiles its body on every call).
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
from repro.models import xlstm_blocks as jxb  # noqa: E402
from repro.models.lm import XLSTMLM as JaxXLSTM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402

import test_torch_moe_interop as interop  # noqa: E402  (its replica scenario, run here on the xLSTM)
import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import meta as port_meta  # noqa: E402
from repro_torch.data.synthetic import PromptSet  # noqa: E402
from repro_torch.kernels import checksum as ck  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as serve_main  # noqa: E402
from repro_torch.models import build_model, check_ported, check_trainable, xlstm_blocks as xb  # noqa: E402
from repro_torch.models.lm import XLSTMLM  # noqa: E402
from repro_torch.models.params import decoder_shapes, from_numpy, init_params  # noqa: E402
from repro_torch.rl.loop import RLConfig, RolloutWorker, sample_responses  # noqa: E402
from repro_torch.training import steps as psteps  # noqa: E402

ARCH = "xlstm-350m"
TOL = LOSS_TOL = 2e-5
BF16_TOL = 2e-2
#: the parameters drawn away from their init value (zeros), with their scale
_MOVED = {"ln": 0.1, "final_ln": 0.1, "b_if": 0.3, "b_gates": 0.3}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _scaled_close(got, want, tol=TOL):
    """``max |got - want| <= tol * max |want|``."""
    got, want = _np(got).astype(np.float64), np.asarray(_np(want), np.float64)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, (err, scale)


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfgs(**kw):
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _jax_tree(jm, named, dtype=jnp.float32):
    template = jm.param_specs()
    flat = named_tensors(template)
    leaves = [jnp.asarray(named[k]).astype(dtype) for k in flat]
    return jax.tree.unflatten(jax.tree.structure(jm.init(jax.random.PRNGKey(0), jnp.float32)), leaves)


def _jax_params(jcfg, seed: int = 0):
    """The JAX ``XLSTMLM``'s parameters as numpy by name, the tensors of
    ``_MOVED`` drawn away from zero, and the JAX tree holding them."""
    jm = JaxXLSTM(jcfg)
    named = {k: np.asarray(v) for k, v in named_tensors(jm.init(jax.random.PRNGKey(seed), jnp.float32)).items()}
    rng = np.random.default_rng(7)
    for k in named:
        leaf = k.rsplit("/", 1)[-1]
        if leaf in _MOVED:
            named[k] = (named[k] + rng.standard_normal(named[k].shape) * _MOVED[leaf]).astype(np.float32)
    return jm, _jax_tree(jm, named), named


@pytest.fixture(scope="module")
def model():
    jcfg, pcfg = _cfgs()
    jm, jp, named = _jax_params(jcfg)
    return jcfg, pcfg, jm, jp, named, build_model(pcfg), from_numpy(named, "cpu")


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


_JITTED = {}


def _jit(jm, name):
    """``jm``'s method ``name`` under ``jax.jit`` (``max_len`` static), one
    per model and method."""
    key = (id(jm), name)
    if key not in _JITTED:
        static = ("max_len",) if name == "prefill" else ()
        _JITTED[key] = (jm, jax.jit(getattr(jm, name), static_argnames=static))
    return _JITTED[key][1]


def _states_close(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for n in want:
        assert tuple(got[n].shape) == tuple(want[n].shape), n
        assert got[n].dtype == torch.float32, n
        _close(got[n], want[n], tol)


def _caches_close(got, want, tol=TOL):
    """Every entry f32, of the JAX cache's shape, held by ``_scaled_close``."""
    assert got.keys() == want.keys()
    for part in want:
        assert got[part].keys() == want[part].keys()
        for n in want[part]:
            assert got[part][n].dtype == torch.float32, (part, n)
            _scaled_close(got[part][n], want[part][n], tol)


# -- the config -------------------------------------------------------------------


def test_full_and_reduced_configs_are_the_ssm_family():
    """xlstm-350m at its published widths: 12 pairs of one mLSTM block
    (d_in 2048, 4 heads of 512) and one sLSTM block (4 heads of 256). The
    tree holds 405,283,936 elements, ``param_count()`` says 405,159,936
    (its formula counts 24 mLSTM-like layers with q/k/v of ``d x d_in``;
    both packages share it)."""
    full = get_config(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.num_heads, full.vocab) == ("ssm", 24, 1024, 4, 50304)
    assert dataclasses.astuple(full.xlstm) == (2.0, 2)
    assert xb.mlstm_dims(full) == (2048, 4, 512) == jxb.mlstm_dims(jax_get_config(ARCH))
    model = build_model(full)
    assert isinstance(model, XLSTMLM) and (model.pairs, model.n_mlstm_per_pair) == (12, 1)
    assert sum(int(np.prod(s)) for _, s in decoder_shapes(full)) == 405_283_936
    assert full.param_count() == jax_get_config(ARCH).param_count() == 405_159_936
    red = get_config(ARCH).reduced()
    assert (red.num_layers, red.d_model, red.num_heads, red.vocab) == (4, 64, 4, 256)
    with pytest.raises(ValueError, match="multiple of slstm_every"):
        XLSTMLM(dataclasses.replace(red, num_layers=3))
    with pytest.raises(ValueError, match="unknown mLSTM form"):
        XLSTMLM(red, mlstm="quadratic")


# -- the mLSTM forms ----------------------------------------------------------------


def _mlstm_inputs(seed, b, h, t, dh, *, f_shift=2.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(3))
    i_raw = rng.standard_normal((b, h, t)).astype(np.float32)
    f_raw = (rng.standard_normal((b, h, t)) + f_shift).astype(np.float32)
    return q, k, v, i_raw, f_raw


def _state(seed, b, h, dh):
    rng = np.random.default_rng(seed)
    return {"c": (rng.standard_normal((b, h, dh, dh)) * 0.5).astype(np.float32),
            "n": (rng.standard_normal((b, h, dh)) * 0.5).astype(np.float32),
            "m": (rng.standard_normal((b, h)) * 0.5).astype(np.float32)}


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("t", [1, 7, 37])
def test_mlstm_parallel_matches_jax(t):
    args = _mlstm_inputs(t, 2, 3, t, 8)
    want = jax.jit(jxb._mlstm_parallel)(*(jnp.asarray(a) for a in args))
    got = xb._mlstm_parallel(*_t(args))
    assert got.shape == (2, 3, t, 8) and got.dtype == torch.float32
    _close(got, want)


#: (T, chunk) of ``_mlstm_chunked``: below, equal to and not a multiple of
#: a chunk of 16, and 300 at the default 256 (two chunks, 212 padded steps)
CHUNK_CASES = [(5, 16), (16, 16), (37, 16), (300, 256)]


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize("t,chunk", CHUNK_CASES, ids=["below_chunk", "one_chunk", "not_a_multiple", "t300_chunk256"])
def test_mlstm_chunked_matches_jax(t, chunk, init):
    """The outputs and the final state against the JAX chunked form (the
    same ``chunk`` on both sides); without an initial state also against the
    parallel form and the folded state."""
    b, h, dh = (1, 2, 8) if t == 300 else (2, 3, 8)
    args = _mlstm_inputs(t + chunk, b, h, t, dh)
    s0 = _state(t, b, h, dh) if init else None
    fn = jax.jit(lambda *a, init=None: jxb._mlstm_chunked(*a, chunk=chunk, init=init))
    want, want_s = fn(*(jnp.asarray(a) for a in args), init=None if s0 is None else {
        n: jnp.asarray(v) for n, v in s0.items()})
    got, got_s = xb._mlstm_chunked(*_t(args), chunk=chunk, init=None if s0 is None else {
        n: torch.from_numpy(v) for n, v in s0.items()})
    assert got.shape == (b, h, t, dh)
    _close(got, want)
    _states_close(got_s, want_s)
    if not init:
        _close(got, xb._mlstm_parallel(*_t(args)))
        fold = xb._mlstm_fold_state(*_t(args))
        _states_close(fold, jax.jit(jxb._mlstm_fold_state)(*(jnp.asarray(a) for a in args)))
        # the fold and the chunked state hold C, n under their own stabilisers
        for n in ("c", "n"):
            scale = torch.exp(fold["m"] - got_s["m"]).reshape(b, h, *([1] * (fold[n].dim() - 2)))
            _close(fold[n] * scale, got_s[n], 1e-4)


def test_mlstm_step_matches_jax_and_the_chunked_form():
    """One step of the recurrence from a random state against the JAX
    step; 9 steps from a zero state against the chunked form over the same
    9 positions (outputs and state)."""
    q, k, v, i_raw, f_raw = _mlstm_inputs(3, 2, 3, 9, 8)
    s0 = _state(4, 2, 3, 8)
    step = jax.jit(jxb._mlstm_step)
    want, want_s = step({n: jnp.asarray(a) for n, a in s0.items()},
                        *(jnp.asarray(a[:, :, 0]) for a in (q, k, v, i_raw, f_raw)))
    got, got_s = xb._mlstm_step({n: torch.from_numpy(a) for n, a in s0.items()},
                                *(torch.from_numpy(a[:, :, 0].copy()) for a in (q, k, v, i_raw, f_raw)))
    _close(got, want)
    _states_close(got_s, want_s)
    state = xb._mlstm_zero_state(2, 3, 8, "cpu")
    outs = []
    for t in range(9):
        o, state = xb._mlstm_step(state, *(torch.from_numpy(a[:, :, t].copy()) for a in (q, k, v, i_raw, f_raw)))
        outs.append(o)
    chunked, chunked_s = xb._mlstm_chunked(*_t((q, k, v, i_raw, f_raw)), chunk=4)
    _close(torch.stack(outs, 2), chunked, 1e-4)
    for n in ("c", "n"):  # under each form's stabiliser
        scale = torch.exp(state["m"] - chunked_s["m"]).reshape(2, 3, *([1] * (state[n].dim() - 2)))
        _close(state[n] * scale, chunked_s[n], 1e-4)


def _block_params(named, prefix, index):
    return {k.rsplit("/", 1)[-1]: v[index] for k, v in named.items() if k.startswith(prefix)}


#: mlstm_block_apply's cases: (the cache's length before the call, or None
#: for no cache, and the call's tokens)
BLOCK_CASES = {"no_cache": (None, 9), "one_token": (7, 1), "chunk_behind_a_cache": (7, 5), "one_token_alone": (None, 1)}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_mlstm_block_apply_matches_jax(case):
    """One mLSTM block of the reduced config (pair 1's) against the JAX
    block under ``jit``: the output and the new state. The cached cases
    run from the state a cacheless call of ``prefix`` tokens left."""
    jcfg, pcfg = _cfgs()
    _, _, named = _jax_params(jcfg)
    lp = _block_params(named, "pairs/mlstm/", (1, 0))
    jp = {n: jnp.asarray(v) for n, v in lp.items()}
    pp = {n: torch.from_numpy(v.copy()) for n, v in lp.items()}
    block = jax.jit(lambda p, x, cache: jxb.mlstm_block_apply(jcfg, p, x, cache=cache))
    prefix, seq = BLOCK_CASES[case]
    x = np.random.default_rng(3).standard_normal((2, (prefix or 0) + seq, pcfg.d_model)).astype(np.float32)
    jc = pc = None
    if prefix is not None:
        _, jc = block(jp, jnp.asarray(x[:, :prefix]), None)
        _, pc = xb.mlstm_block_apply(pcfg, pp, torch.from_numpy(x[:, :prefix]))
        _states_close(pc, jc)
    want, want_s = block(jp, jnp.asarray(x[:, prefix or 0 :]), jc)
    got, got_s = xb.mlstm_block_apply(pcfg, pp, torch.from_numpy(x[:, prefix or 0 :]), cache=pc)
    _close(got, want)
    _states_close(got_s, want_s)


def test_mlstm_block_forms_agree():
    """``form="parallel"`` (the quadratic form and the folded state) against
    the chunked form: the outputs, and the state once both are put under
    one stabiliser; a cache is refused."""
    jcfg, pcfg = _cfgs()
    _, _, named = _jax_params(jcfg)
    pp = {n: torch.from_numpy(v.copy()) for n, v in _block_params(named, "pairs/mlstm/", (0, 0)).items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 21, pcfg.d_model)).astype(np.float32))
    got, got_s = xb.mlstm_block_apply(pcfg, pp, x, form="parallel")
    want, want_s = xb.mlstm_block_apply(pcfg, pp, x)
    _close(got, want)
    for n in ("c", "n"):
        scale = torch.exp(got_s["m"] - want_s["m"]).reshape(2, 4, *([1] * (got_s[n].dim() - 2)))
        _close(got_s[n] * scale, want_s[n], 1e-4)
    with pytest.raises(ValueError, match="parallel form"):
        xb.mlstm_block_apply(pcfg, pp, x, cache=want_s, form="parallel")


def test_mlstm_block_keeps_jaxs_dtypes():
    """bf16 activations: the output bf16 and the state f32, within the bf16
    tolerance of the JAX block (relative L2), through the chunked form and
    one step."""
    jcfg, pcfg = _cfgs()
    _, _, named = _jax_params(jcfg)
    lp = _block_params(named, "pairs/mlstm/", (0, 0))
    jp = {n: jnp.asarray(v).astype(jnp.bfloat16) for n, v in lp.items()}
    pp = {n: torch.from_numpy(v).to(torch.bfloat16) for n, v in lp.items()}
    x = np.random.default_rng(4).standard_normal((2, 11, pcfg.d_model)).astype(np.float32)
    block = jax.jit(lambda p, x, cache: jxb.mlstm_block_apply(jcfg, p, x, cache=cache))
    out, st = xb.mlstm_block_apply(pcfg, pp, torch.from_numpy(x[:, :10]).to(torch.bfloat16))
    jout, jst = block(jp, jnp.asarray(x[:, :10]).astype(jnp.bfloat16), None)
    assert out.dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in st.values())
    assert _rel_l2(out, jout) <= BF16_TOL
    out1, st1 = xb.mlstm_block_apply(pcfg, pp, torch.from_numpy(x[:, 10:]).to(torch.bfloat16), cache=st)
    jout1, jst1 = block(jp, jnp.asarray(x[:, 10:]).astype(jnp.bfloat16), jst)
    assert out1.dtype == torch.bfloat16 and _rel_l2(out1, jout1) <= BF16_TOL
    for n in st1:
        assert _rel_l2(st1[n], jst1[n]) <= BF16_TOL, n


def _mlstm_block_f64(cfg, p, x):
    """The mLSTM block in float64 numpy through the parallel form: the exact
    answer both packages' f32 blocks are held to."""
    p = {n: v.astype(np.float64) for n, v in p.items()}
    x = x.astype(np.float64)
    d_in, nh, dh = xb.mlstm_dims(cfg)
    b, t, _ = x.shape
    h = x / np.sqrt((x**2).mean(-1, keepdims=True) + 1e-6) * (1 + p["ln"])
    up = h @ p["w_up"]
    xm, z = up[..., :d_in], up[..., d_in:]

    def heads(a):
        return a.reshape(b, t, nh, dh).transpose(0, 2, 1, 3)

    q, k, v = heads(xm @ p["wq"]), heads(xm @ p["wk"]), heads(xm @ p["wv"])
    g = (xm @ p["w_if"] + p["b_if"]).reshape(b, t, 2, nh).transpose(0, 3, 1, 2)
    cum = np.cumsum(-np.logaddexp(0, -g[..., 1]), -1)
    dmat = np.where(np.tril(np.ones((t, t), bool)), cum[..., :, None] - cum[..., None, :] + g[..., None, :, 0],
                    -np.inf)
    m = dmat.max(-1)
    scores = q @ k.swapaxes(-1, -2) / np.sqrt(dh) * np.exp(dmat - m[..., None])
    out = (scores @ v) / np.maximum(np.abs(scores.sum(-1)), np.exp(-m))[..., None]
    y = out.transpose(0, 2, 1, 3).reshape(b, t, d_in) * (z / (1 + np.exp(-z)))
    return x + y @ p["w_down"]


def test_mlstm_block_at_the_published_widths_matches_jax():
    """One mLSTM block at xlstm-350m's widths (d_model 1024, d_in 2048, 4
    heads of 512), B 1, T 300 (two chunks of 256, the second padded),
    weights drawn at the init's scale with the norm and gate biases moved.
    Here the f32 answer is ill-conditioned: the chunk's cumulative sums of
    log f reach ~600, where an f32 ulp is 6e-5, and the two packages sum
    them in different orders (torch sequentially, XLA's CPU lowering as a
    parallel prefix); the normaliser divides by small sums. So both are held
    to the float64 answer (``_mlstm_block_f64``): the port's error is at most
    twice the JAX block's own (they measure 1.5e-4 and 1.2e-4 on outputs of
    up to 12.5), the two within 1e-4 of the output's max |value| of each
    other, and the final states within 2e-5 of their max |value|."""
    jcfg = jax_get_config(ARCH)
    pcfg = get_config(ARCH)
    rng = np.random.default_rng(12)
    lp = {}
    for n, shape in ((n, p.shape) for n, p in xb.mlstm_specs(pcfg).items()):
        std = 1.0 / np.sqrt(shape[-2]) if len(shape) > 1 else (0.1 if n == "ln" else 1.0)
        lp[n] = (rng.standard_normal(shape) * std).astype(np.float32)
    x = rng.standard_normal((1, 300, pcfg.d_model)).astype(np.float32)
    want, want_s = jax.jit(lambda p, x: jxb.mlstm_block_apply(jcfg, p, x))({n: jnp.asarray(v) for n, v in lp.items()},
                                                                          jnp.asarray(x))
    got, got_s = xb.mlstm_block_apply(pcfg, {n: torch.from_numpy(v) for n, v in lp.items()}, torch.from_numpy(x))
    exact = _mlstm_block_f64(pcfg, lp, x)
    want, got = np.asarray(want, np.float64), _np(got).astype(np.float64)
    port_err, jax_err = float(np.abs(got - exact).max()), float(np.abs(want - exact).max())
    assert port_err <= 2 * jax_err, (port_err, jax_err)
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(exact).max())
    for n in want_s:
        w = np.asarray(want_s[n], np.float64)
        assert got_s[n].shape == w.shape and got_s[n].dtype == torch.float32, n
        assert float(np.abs(_np(got_s[n]) - w).max()) <= 2e-5 * float(np.abs(w).max()), n


@pytest.mark.parametrize("cached", [False, True])
def test_slstm_block_apply_matches_jax(cached):
    """One sLSTM block of the reduced config: the whole sequence from no
    cache, and the split at 5 (the rest from the cache the first 5 left),
    against the JAX block under ``jit``; the split equals the whole."""
    jcfg, pcfg = _cfgs()
    _, _, named = _jax_params(jcfg)
    lp = _block_params(named, "pairs/slstm/", 1)
    jp = {n: jnp.asarray(v) for n, v in lp.items()}
    pp = {n: torch.from_numpy(v.copy()) for n, v in lp.items()}
    block = jax.jit(lambda p, x, cache: jxb.slstm_block_apply(jcfg, p, x, cache=cache))
    x = np.random.default_rng(6).standard_normal((2, 13, pcfg.d_model)).astype(np.float32)
    whole, whole_s = xb.slstm_block_apply(pcfg, pp, torch.from_numpy(x))
    if not cached:
        want, want_s = block(jp, jnp.asarray(x), None)
        _close(whole, want)
        _states_close(whole_s, want_s)
        return
    _, jc = block(jp, jnp.asarray(x[:, :5]), None)
    a, pc = xb.slstm_block_apply(pcfg, pp, torch.from_numpy(x[:, :5]))
    _states_close(pc, jc)
    want, want_s = block(jp, jnp.asarray(x[:, 5:]), jc)
    got, got_s = xb.slstm_block_apply(pcfg, pp, torch.from_numpy(x[:, 5:]), cache=pc)
    _close(got, want)
    _states_close(got_s, want_s)
    _close(torch.cat([a, got], 1), whole, 2e-3)  # tests/test_blocks.py's streaming check


# -- the model ------------------------------------------------------------------------


@pytest.mark.parametrize("s", [7, 37])
def test_forward_matches_jax(model, s):
    jcfg, pcfg, jm, jp, _, pm, pp = model
    toks = _tokens(pcfg, s, 2, s)
    want = _jit(jm, "forward")(jp, {"tokens": jnp.asarray(toks)})
    got = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, s, pcfg.vocab) and got.dtype == torch.float32
    _scaled_close(got, want)
    _scaled_close(XLSTMLM(pcfg, mlstm="parallel").forward(pp, {"tokens": torch.from_numpy(toks).long()}), want)


def test_prefill_matches_jax(model):
    """The last position's logits and every cache entry: the states of both
    pairs' mLSTM and sLSTM blocks, stacked as the JAX cache."""
    jcfg, pcfg, jm, jp, _, pm, pp = model
    toks = _tokens(pcfg, 21, 2, 19)
    jl, jc, jn = _jit(jm, "prefill")(jp, {"tokens": jnp.asarray(toks)}, max_len=25)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, max_len=25)
    assert pn == int(jn) == 19 and pl.shape == (2, 1, pcfg.vocab)
    _scaled_close(pl, jl)
    _caches_close(pc, jc)
    assert pc["mlstm"]["c"].shape == (2, 1, 2, 4, 32, 32) and pc["slstm"]["h"].shape == (2, 2, 4, 16)
    assert {n: tuple(t.shape) for n, t in pc["mlstm"].items()} == {
        n: p.shape for n, p in pm.cache_specs(2, 25)["mlstm"].items()}


@pytest.mark.parametrize("chunk", [1, 3], ids=["one_token_steps", "three_token_steps"])
def test_decode_chain_matches_jax(model, chunk):
    """Prefill 10 tokens, then 6 decode calls of ``chunk`` tokens each (one
    step of the recurrence, or the chunked form from the cached state):
    every call's logits, the final caches, and the logits against the
    teacher-forced forward of the whole sequence."""
    jcfg, pcfg, jm, jp, _, pm, pp = model
    toks = _tokens(pcfg, 5, 2, 10 + 6 * chunk)
    jl, jc, n = _jit(jm, "prefill")(jp, {"tokens": jnp.asarray(toks[:, :10])})
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :10]).long()})
    full = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    cache_id = id(pc)
    for i in range(6):
        t = toks[:, 10 + i * chunk : 10 + (i + 1) * chunk]
        jl, jc = _jit(jm, "decode")(jp, jc, jnp.asarray(t), jnp.int32(10 + i * chunk))
        pl, pc = pm.decode(pp, pc, torch.from_numpy(t).long(), pn + i * chunk)
        assert pl.shape == (2, chunk, pcfg.vocab) and id(pc) == cache_id
        _scaled_close(pl, jl)
        _scaled_close(pl, full[:, 10 + i * chunk : 10 + (i + 1) * chunk])
    _caches_close(pc, jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_from_init_cache_matches_jax(model, dtype):
    """12 one-token steps from ``init_cache`` (every entry f32 whatever the
    weights' dtype, both stabilisers at -1e30), through ``make_decode_step``:
    every step's logits and the final caches, in f32 within 2e-5 of their
    max |value|. With bf16 weights the chain's logits as a whole and each
    final state within 2e-2 relative L2; and each step's distance from the
    JAX step at most the JAX bf16 step's own distance from the f32 logits
    (bf16 rounding moves either package's logits by 2-7% relative L2 here,
    and the two round a few intermediates differently from the third step
    on: one step sits 2.2% from the JAX one)."""
    jcfg, pcfg, jm, _, named, pm, pp32 = model
    jdt, pdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jp = _jax_tree(jm, named, jdt)
    pp = {k: t.to(pdt) for k, t in pp32.items()}
    jc = jm.init_cache(2, 12, jdt)
    pc = pm.init_cache(2, 12, pdt, "cpu")
    c32 = pm.init_cache(2, 12, torch.float32, "cpu")
    assert all(t.dtype == torch.float32 for d in pc.values() for t in d.values())
    assert bool((pc["mlstm"]["m"] == -1e30).all()) and bool((pc["slstm"]["m"] == -1e30).all())
    _caches_close(pc, jc)
    toks = _tokens(pcfg, 9, 2, 12)
    step = psteps.make_decode_step(pm, ring=True)  # the xLSTM takes no ring: its decode as always
    got, want = [], []
    for i in range(12):
        t = torch.from_numpy(toks[:, i : i + 1]).long()
        jl, jc = _jit(jm, "decode")(jp, jc, jnp.asarray(toks[:, i : i + 1]), jnp.int32(i))
        pl, pc = step(pp, pc, t, i)
        if dtype == "float32":
            _scaled_close(pl, jl)
            continue
        l32, c32 = pm.decode(pp32, c32, t, i)
        assert _rel_l2(pl, jl) <= _rel_l2(jl, l32), (i, _rel_l2(pl, jl), _rel_l2(jl, l32))
        got.append(_np(pl))
        want.append(np.asarray(jl, np.float32))
    if dtype == "float32":
        _caches_close(pc, jc)
        return
    assert _rel_l2(np.stack(got), np.stack(want)) <= BF16_TOL
    for part in jc:
        for n in jc[part]:
            assert _rel_l2(pc[part][n], jc[part][n]) <= BF16_TOL, (part, n)


# -- parameters --------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_parameter_names_and_shapes_are_the_jax_param_specs(reduced):
    """The full config's names, shapes and order (24 layers; specs only,
    nothing allocated on either side) and the reduced one's, against the
    JAX ``XLSTMLM.param_specs()`` flattened; and the transfer units of a
    bf16 replica of them, by each package's ``build_units``."""
    got, want = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        got, want = got.reduced(), want.reduced()
    shapes = decoder_shapes(got)
    assert shapes == [(n, tuple(s.shape)) for n, s in named_tensors(JaxXLSTM(want).param_specs()).items()]
    names = [n for n, _ in shapes]
    assert names == ["embed", "final_ln", "head"] + [f"pairs/mlstm/{n}" for n in (
        "b_if", "ln", "w_down", "w_if", "w_up", "wk", "wq", "wv")] + [f"pairs/slstm/{n}" for n in (
            "b_gates", "ln", "r_gates", "w_gates", "w_out")]
    if not reduced:
        assert dict(shapes)["pairs/slstm/r_gates"] == (12, 4, 4, 256, 256)
        assert dict(shapes)["pairs/mlstm/wq"] == (12, 1, 2048, 2048) and dict(shapes)["pairs/mlstm/b_if"] == (12, 1, 8)

    def units(meta):
        metas = [meta.TensorMeta(n, s, "bfloat16", 2 * int(np.prod(s))) for n, s in shapes]
        return [dataclasses.astuple(u) for u in meta.build_units(metas)]

    assert units(port_meta) == units(jax_meta)


def test_init_params_draws_as_the_specs_say():
    """``init_params`` follows the specs' init kinds and scales: the norms
    and gate biases zeros, the rest normal at std ``scale/sqrt(shape[-2])``,
    ``r_gates`` at scale 0.5 (checked by their moments, here and in the
    JAX package's ``init``)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), d_model=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert list(params) == [n for n, _ in decoder_shapes(cfg)]
    zeros = {n for n, t in params.items() if not t.any()}
    assert zeros == {"final_ln", "pairs/mlstm/ln", "pairs/mlstm/b_if", "pairs/slstm/ln", "pairs/slstm/b_gates"}
    jax_init = {k: np.asarray(v) for k, v in named_tensors(
        JaxXLSTM(dataclasses.replace(jax_get_config(ARCH).reduced(), d_model=256)).init(
            jax.random.PRNGKey(0), jnp.float32)).items()}
    assert {n for n, t in jax_init.items() if not t.any()} == zeros
    for n, t in params.items():
        if n in zeros:
            continue
        scale = 0.5 if n.endswith("r_gates") else 1.0
        std = scale / np.sqrt(t.shape[-2])
        assert abs(float(t.mean())) < 0.1 * std, n
        assert float(t.std()) == pytest.approx(std, rel=0.1), n
        assert float(jax_init[n].std()) == pytest.approx(std, rel=0.1), n


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


def test_rollout_worker_serves_v0_then_v1(model):
    """A publisher registers the carried-across JAX params v0; a
    ``RolloutWorker`` replicates them, samples 4 x (6 + 20) tokens (the
    prefill, then 20 decode steps through the recurrent states), updates to
    v1 in the same buffers and samples again; each round's logprobs are the
    JAX forward's on the sampled tokens."""
    jcfg, pcfg, jm, _, named, _, _ = model
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
    pub = hub.open("actor", "trainer", 1, 0, datacenter="dc0")
    pub.register(from_numpy(named, "cpu"))
    pub.publish(0)
    cfg = RLConfig(prompt_len=6, response_len=20, num_prompts=2, group_size=2)
    out = []
    w = RolloutWorker("rollout-0", hub, cfg, pcfg, PromptSet(pcfg.vocab, 6), out, threading.Event())
    assert isinstance(w.model, XLSTMLM) and w.connect(timeout=30) == 0
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
    before = fa.LAUNCHES.value, ck.LAUNCHES.value
    sample_responses(pm, pp, torch.from_numpy(_tokens(pcfg, 8, 2, 4)).long(), 3, torch.Generator().manual_seed(1))
    assert (fa.LAUNCHES.value, ck.LAUNCHES.value) == before


def test_serve_answers_a_reduced_xlstm():
    rows = serve_main.serve(get_config(ARCH).reduced(), requests=2, prompt_len=6, gen_len=3, rounds=2, device="cpu",
                            dtype=torch.float32)
    assert [r["version"] for r in rows] == [0, 0] and all(r["tokens"] == 6 for r in rows)


def test_serve_entry_point_admits_all_24_layers(monkeypatch):
    """Two bf16 copies of xlstm-350m (the publisher's and the rollout's,
    1.62 GB by ``param_count``) fit an 80 GB card: ``serve.main`` passes
    the published depth on."""
    monkeypatch.setattr(serve_main, "device_memory", lambda device: 80 * 10**9)
    served = []
    monkeypatch.setattr(serve_main, "serve", lambda cfg, **kw: served.append((cfg, kw)))
    serve_main.main(["--arch", ARCH, "--device", "cpu", "--requests", "8", "--prompt-len", "512", "--gen-len", "64"])
    cfg, kw = served[0]
    assert cfg.num_layers == 24 and 2 * 2 * cfg.param_count() == 1_620_639_744
    assert (kw["requests"], kw["prompt_len"], kw["gen_len"]) == (8, 512, 64)
    check_ported(cfg)
    check_trainable(cfg)


@pytest.mark.parametrize("pub_name", ["jax", "port"])
def test_xlstm_replica_crosses_the_packages_bit_equal(pub_name, monkeypatch):
    """The xLSTM's names and unit schedule (the sLSTM's 5-D ``r_gates``, the
    mLSTM's 8-element ``b_if`` rows) at d_model 256, bf16, raw (dc0) and
    int8 (dc1), through a networked controller of the other package than
    the publisher's: every replica's bytes and every v1 manifest (units and
    checksums) equal the same scenario run through the JAX package alone."""
    monkeypatch.setattr(interop.jax_codec.Int8Codec, "_resolve_jax", lambda self: None)
    pub_pkg = interop.PACKAGES[pub_name]
    read_pkg = interop.PORT if pub_pkg is interop.JAX else interop.JAX
    jcfg, pcfg = _cfgs(d_model=256)
    shapes = [(n, tuple(s.shape)) for n, s in named_tensors(JaxXLSTM(jcfg).param_specs()).items()]
    assert shapes == decoder_shapes(pcfg)
    rng = np.random.default_rng(5)
    v0, v1 = {}, {}
    for name, shape in shapes:
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        w1 = w.reshape(-1).copy()
        w1[: w1.size // 256 * 256].reshape(-1, 256)[::8] += 0.01
        v0[name] = w.astype(interop.DTYPES["bfloat16"])
        v1[name] = w1.reshape(shape).astype(interop.DTYPES["bfloat16"])
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
    assert names == set(v0) and {"pairs/slstm/r_gates", "pairs/mlstm/b_if"} <= names
