"""Flash attention's gradient in the port against the JAX package's, on the CPU.

``attention_backward_plain`` (the algorithm of the backward kernels, in
plain PyTorch) and the ``FlashAttention`` Function's CPU wiring (the
plain forward with its log-sum-exp, then the plain backward) must match
autograd through ``attention_plain``, ``jax.grad`` of the jnp
``chunked_attention`` the JAX models train through (with ``q_offset``,
``kv_len`` and the softcap) and ``jax.grad`` of the oracle
``attention_ref``. Inputs and output cotangents come from numpy with a
seed; f32, tolerance 2e-5 (``tests/test_kernels.py``'s f32 tolerance)
relative and absolute, as ``assert_allclose``; and f16 through the
Function (``F16_TOL``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = 2e-5

#: (b, hq, hkv, sq, sk, d, causal, softcap, q_offset, kv_len)
CASES = [
    (2, 4, 4, 13, 13, 16, True, 0.0, 0, None),  # G 1, odd length
    (2, 8, 2, 13, 13, 16, True, 0.0, 0, None),  # G 4
    (1, 4, 1, 9, 21, 16, False, 0.0, 0, None),  # not causal, MQA, cross-length
    (2, 8, 2, 7, 30, 32, True, 0.0, 17, 24),  # q_offset, kv_len < Sk
    (1, 4, 2, 11, 40, 16, False, 0.0, 0, 29),  # kv_len, not causal
    (2, 8, 2, 17, 17, 32, True, 5.0, 0, None),  # softcap (small: tanh bends)
    (1, 8, 2, 5, 64, 64, True, 50.0, 40, 45),  # softcap, offset, head_dim 64
    (1, 16, 4, 33, 33, 128, True, 0.0, 0, None),  # head_dim 128, GQA 4:1
]


def _inputs(case, seed=0):
    b, hq, hkv, sq, sk, d, *_ = case
    rng = np.random.default_rng(seed + sq * 7 + d)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d))]


def _kw(case):
    *_, causal, cap, q_offset, kv_len = case
    return dict(causal=causal, softcap=cap, q_offset=q_offset, kv_len=kv_len)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32), rtol=TOL, atol=TOL)


def _autograd_plain(q, k, v, dout, kw):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.attention_plain(*leaves, **kw)
    return [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(dout))]


def _jax_grads(fn, q, k, v, dout):
    def f(q, k, v):
        return jnp.sum(fn(q, k, v) * dout)

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _chunked(kw):
    sk_valid = kw["kv_len"]

    def fn(q, k, v):
        return chunked_attention(q, k, v, causal=kw["causal"], q_offset=kw["q_offset"],
                                 kv_len=None if sk_valid is None else jnp.asarray(sk_valid),
                                 attn_softcap=kw["softcap"], block_k=8)

    return fn


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_backward_plain_equals_autograd_of_plain(case):
    q, k, v, dout = _inputs(case)
    kw = _kw(case)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out = fa.attention_plain(tq, tk, tv, **kw)
    lse = fa.attention_lse_plain(tq, tk, **kw)
    got = fa.attention_backward_plain(tq, tk, tv, out, lse, tdo, **kw)
    for g, w in zip(got, _autograd_plain(q, k, v, dout, kw)):
        _close(g.numpy(), w)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_function_on_the_cpu_equals_jax_grad_of_chunked_attention(case):
    """The Function's CPU wiring, as the model calls it: flash_attention
    on leaves that require a gradient."""
    q, k, v, dout = _inputs(case, seed=1)
    kw = _kw(case)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = fa.LAUNCHES.value, {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    out = fa.flash_attention(*leaves, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    # the plain versions launch nothing
    assert (fa.LAUNCHES.value, {n: c.value for n, c in fa.BWD_LAUNCHES.items()}) == before
    want = _jax_grads(_chunked(kw), q, k, v, dout)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    _close(out.detach().numpy(), _chunked(kw)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


#: f16 gradients against jax.grad in f32 of the same f16 values: the
#: port computes in f32 and rounds each gradient (and the forward's
#: output, which D_i reads) once to f16, 2^-11 relative; 2e-3 of each
#: gradient's max |value| holds that with room
F16_TOL = 2e-3


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_function_in_float16_equals_jax_grad_of_chunked_attention(case):
    q, k, v, dout = (a.astype(np.float16) for a in _inputs(case, seed=3))
    kw = _kw(case)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, **kw)
    assert out.dtype == torch.float16
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    want = _jax_grads(_chunked(kw), *(a.astype(np.float32) for a in (q, k, v, dout)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float16
        w = np.asarray(w)
        assert np.abs(g.float().numpy() - w).max() <= F16_TOL * np.abs(w).max()


@pytest.mark.parametrize("case", [c for c in CASES if c[8] == 0 and c[9] is None], ids=lambda c: "x".join(map(str, c)))
def test_function_on_the_cpu_equals_jax_grad_of_attention_ref(case):
    q, k, v, dout = _inputs(case, seed=2)
    kw = _kw(case)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves, torch.from_numpy(dout))
    want = _jax_grads(lambda q, k, v: attention_ref(q, k, v, causal=kw["causal"], softcap=kw["softcap"]),
                      q, k, v, dout)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_lse_plain_is_the_log_normaliser(case):
    """exp(s - lse) sums to one over each row's live keys: the P the
    backward recomputes is the forward's softmax."""
    q, k, v, _ = _inputs(case)
    kw = _kw(case)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    lse = fa.attention_lse_plain(tq, tk, **kw)
    b, hq, sq, _ = q.shape
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    s, mask, _ = fa._scores_plain(tq, tk, kw["causal"], kw["softcap"], kw["q_offset"],
                                  kw["kv_len"] or k.shape[2])
    p = torch.exp(s - lse.reshape(s.shape[:-1] + (1,)))
    _close(p.sum(-1).numpy(), np.ones(s.shape[:-1], np.float32))


@pytest.mark.parametrize("shape", [(1, 32, 8, 1, 576), (16, 32, 8, 1, 576), (2, 32, 8, 2, 600), (1, 4, 4, 64, 64),
                                   (1, 8, 2, 16, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_for_a_gradient_is_never_decode(shape, dtype):
    b, hq, hkv, sq, sk = shape
    q = torch.zeros((b, hq, sq, 128), dtype=dtype)
    k = torch.zeros((b, hkv, sk, 128), dtype=dtype)
    want = "tensor_core" if dtype == torch.bfloat16 else "f32"
    assert fa._route(q, k, grad=True) == want
    assert fa._route(q, k) == "decode"  # the serving call of the same shape


def test_serving_calls_stay_off_the_function():
    """Without a gradient wanted (the serving path), flash_attention is
    the plain version on the CPU, with no autograd node and no launch."""
    q, k, v, _ = _inputs(CASES[1])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = fa.LAUNCHES.value, {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
    out = fa.flash_attention(tq, tk, tv)
    assert out.grad_fn is None
    assert torch.equal(out, fa.attention_plain(tq, tk, tv))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    with torch.no_grad():
        assert fa.flash_attention(*leaves).grad_fn is None
    assert (fa.LAUNCHES.value, {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}) == before


def test_head_dim_256_has_no_backward_yet():
    """Head_dim 256 (gemma2) has its backward now: on the CPU the Function
    runs the plain versions, windowed and softcapped, and its gradients
    equal autograd's through attention_plain (f32, 2e-5)."""
    rng = np.random.default_rng(7)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                     for s in ((1, 4, 20, 256), (1, 2, 20, 256), (1, 2, 20, 256), (1, 4, 20, 256)))
    kw = dict(causal=True, softcap=50.0, window=4)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves, dout)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*ref, **kw), ref, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
    fa.flash_attention(q, k, v, **kw)  # serving at head_dim 256 still runs


def test_kernel_backward_refuses_cpu_tensors():
    """No quiet fallback: the kernel launcher takes CUDA tensors only."""
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(CASES[1]))
    lse = fa.attention_lse_plain(q, k)
    with pytest.raises(TypeError, match="unsupported device"):
        fa.launch_backward(q, k, v, fa.attention_plain(q, k, v), lse, dout)


#: hubert-xlarge's head_dim 80: bidirectional (its encoder), causal with a
#: group of 2 and a softcap, and a window with q_offset and kv_len < Sk:
#: (b, hq, hkv, sq, sk, d, causal, softcap, q_offset, kv_len, window)
HEAD_DIM_80_CASES = [
    (1, 4, 4, 77, 77, 80, False, 0.0, 0, None, 0),
    (1, 4, 2, 77, 77, 80, True, 30.0, 0, None, 0),
    (1, 4, 4, 20, 90, 80, True, 0.0, 60, 80, 24),
]


@pytest.mark.parametrize("case", HEAD_DIM_80_CASES, ids=lambda c: "x".join(map(str, c)))
def test_backward_plain_at_head_dim_80_equals_jax_grad_of_chunked_attention(case):
    """``attention_backward_plain`` (what the card's head_dim-80 backward
    kernels are held against) and the Function's CPU wiring against
    ``jax.grad`` of ``chunked_attention`` at head_dim 80."""
    *base, window = case
    q, k, v, dout = _inputs(tuple(base), seed=5)
    kw = dict(_kw(tuple(base)), window=window)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out = fa.attention_plain(tq, tk, tv, **kw)
    lse = fa.attention_lse_plain(tq, tk, **kw)
    got = fa.attention_backward_plain(tq, tk, tv, out, lse, tdo, **kw)
    sk_valid = kw["kv_len"]

    def chunked(q, k, v):
        return chunked_attention(q, k, v, causal=kw["causal"], window=jnp.asarray(window), q_offset=kw["q_offset"],
                                 kv_len=None if sk_valid is None else jnp.asarray(sk_valid),
                                 attn_softcap=kw["softcap"], block_k=8)

    want = _jax_grads(chunked, q, k, v, dout)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    through = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves, torch.from_numpy(dout))
    for g, w in zip(through, want):
        _close(g.numpy(), w)
