"""The CUDA-core flash kernels' tiling, on the CPU.

The `f32` forward route and the `cuda_core` backward pack the G query
heads of a KV head into 64-row sub-tiles (``packed_rows``, which sizes
the backward's stats scratch, and ``packed_row``, the host's copy of
``packed_row`` in csrc/vec.cuh). Their oracle on the card is the plain
PyTorch version, so the plain forward and backward are held here, at the groups
of 7 (yi-34b, deepseek-coder-33b: 56 query heads on 8 KV heads) and 64
(``MAX_GROUP``), to the JAX package's ``attention_ref`` and ``jax.grad``
of the jnp ``chunked_attention`` the JAX models train through. Inputs
from numpy with a seed; f32, tolerance 2e-5 (``tests/test_kernels.py``)
relative and absolute.
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

#: (b, hq, hkv, sq, sk, d, causal, softcap, q_offset, kv_len) at G 7 and 64
CASES = [
    (1, 56, 8, 19, 19, 32, True, 0.0, 0, None),  # G 7, yi-34b's heads
    (1, 14, 2, 11, 30, 64, False, 0.0, 0, 20),  # G 7, kv_len < Sk, not causal
    (1, 7, 1, 13, 13, 16, True, 30.0, 0, None),  # G 7, MQA, softcap
    (1, 64, 1, 9, 9, 16, True, 0.0, 0, None),  # G 64 = MAX_GROUP
    (1, 64, 2, 5, 40, 16, True, 0.0, 30, 35),  # G 64, q_offset, kv_len < Sk
]


def _inputs(case, seed=0):
    b, hq, hkv, sq, sk, d, *_ = case
    rng = np.random.default_rng(seed + hq * 11 + sq)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d))]


def _kw(case):
    *_, causal, cap, q_offset, kv_len = case
    return dict(causal=causal, softcap=cap, q_offset=q_offset, kv_len=kv_len)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32), rtol=TOL, atol=TOL)


def _chunked(kw):
    def fn(q, k, v):
        kv_len = None if kw["kv_len"] is None else jnp.asarray(kw["kv_len"])
        return chunked_attention(q, k, v, causal=kw["causal"], q_offset=kw["q_offset"], kv_len=kv_len,
                                 attn_softcap=kw["softcap"], block_k=8)

    return fn


def _jax_grads(fn, q, k, v, dout):
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_forward_at_large_groups_equals_jax(case):
    q, k, v, _ = _inputs(case)
    kw = _kw(case)
    got = fa.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy()
    _close(got, _chunked(kw)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    if kw["q_offset"] == 0 and kw["kv_len"] is None:
        _close(got, attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=kw["causal"],
                                  softcap=kw["softcap"]))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_backward_at_large_groups_equals_jax_grad(case):
    """attention_backward_plain, the backward kernels' algorithm and their
    oracle on the card, from the plain forward's output and log-sum-exp."""
    q, k, v, dout = _inputs(case, seed=1)
    kw = _kw(case)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out = fa.attention_plain(tq, tk, tv, **kw)
    lse = fa.attention_lse_plain(tq, tk, **kw)
    got = fa.attention_backward_plain(tq, tk, tv, out, lse, tdo, **kw)
    want = _jax_grads(_chunked(kw), q, k, v, dout)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    if kw["q_offset"] == 0 and kw["kv_len"] is None:
        ref = _jax_grads(lambda q, k, v: attention_ref(q, k, v, causal=kw["causal"], softcap=kw["softcap"]),
                         q, k, v, dout)
        for g, w in zip(got, ref):
            _close(g.numpy(), w)


@pytest.mark.parametrize("sq", [1, 2, 63, 64, 65, 127, 129, 577])
def test_packed_rows_cover_every_query_row_once(sq):
    """For every group size 1..64, the sub-tiles' rows hold each (head,
    position) of the group exactly once, and every tile's padding rows
    lie at the tile's end or past Sq."""
    for group in range(1, fa.MAX_GROUP + 1):
        qpt, nsub = fa.packed_rows(sq, group)
        assert qpt * group <= fa.SUB_ROWS and qpt >= 1
        seen = [fa.packed_row(group, qpt, sq, sub, r) for sub in range(nsub + 1) for r in range(fa.SUB_ROWS)]
        live = [x for x in seen if x is not None]
        assert len(live) == len(set(live)) == group * sq, (group, sq)
        assert set(live) == {(g, i) for g in range(group) for i in range(sq)}
        # nsub sub-tiles are enough: the one after them is all padding
        assert all(x is None for x in seen[nsub * fa.SUB_ROWS:])


def test_row_division_in_f32_is_exact():
    """The kernels take r // G as trunc((r + 1/2) * (1/G)) in f32 (csrc/vec.cuh
    packed_row): exact for every row r < 64 and group 1..64."""
    r = np.arange(fa.SUB_ROWS, dtype=np.float32)
    for group in range(1, fa.MAX_GROUP + 1):
        inv = np.float32(1.0) / np.float32(group)
        got = np.trunc((r + np.float32(0.5)) * inv).astype(np.int64)
        np.testing.assert_array_equal(got, np.arange(fa.SUB_ROWS) // group)
