"""The head_dim-256 attention backwards' CPU side.

Both routes' head_dim-256 backwards (``tensor_core``: bf16 on ``wgmma``;
``cuda_core``: f32, f16 and bf16 in f32 FMAs) launch ``pre`` and then one
persistent kernel, ``dkdv_dq``, that walks a work list of dK/dV and dQ
items built on the host (``bwd256_order``). The kernels run only on the
card (``tests/test_torch_gpu.py`` holds them to the plain backward there);
here:

* the work list against a brute-force enumeration of the live (query, key)
  pairs: every (batch, KV head or query head, tile) item exactly once, each
  walking exactly the streamed tiles that hold a live pair of its rows
  (``first .. first + n - 1``), every block's items heaviest first and no
  block more than one item's work past the mean; at phase 10's and phase
  7's launch shapes, at 4672 rows and at the edges (G 1/2/4/7/8, Sq 77 and
  300, kv_len < Sk, q_offset > 0, windows 8/64/4096, not causal);
* the plain backward at head_dim 256, fed the JAX package's inputs, against
  ``jax.grad`` of ``chunked_attention`` at those edges, in f32 within 2e-5
  of each gradient's max |value| (``tests/test_torch_gemma2_train.py``'s
  norm).

Inputs come from numpy with a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import chunked_attention  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = 2e-5

#: (label, b, hq, hkv, sq, sk, causal, q_offset, kv_len, window)
CASES = [
    ("phase 10", 4, 8, 4, 576, 576, True, 0, None, 4096),
    ("phase 7", 2, 8, 4, 512, 512, True, 0, None, 4096),
    ("4672 rows", 2, 8, 4, 4672, 4672, True, 0, None, 4096),
    ("G 1, Sq 77", 1, 4, 4, 77, 77, True, 0, None, 0),
    ("G 2, Sq 300", 1, 8, 4, 300, 300, True, 0, None, 0),
    ("G 4", 1, 16, 4, 130, 130, True, 0, None, 0),
    ("G 7", 1, 56, 8, 129, 129, True, 0, None, 0),
    ("G 8, window 8", 1, 32, 4, 100, 100, True, 0, None, 8),
    ("kv_len < Sk, not causal", 2, 8, 2, 100, 160, False, 0, 120, 0),
    ("q_offset, kv_len < Sk", 1, 8, 2, 64, 300, True, 200, 264, 0),
    ("window 64", 1, 8, 4, 300, 300, True, 0, None, 64),
    ("window 64, not causal, kv_len < Sk", 1, 8, 4, 200, 300, False, 0, 250, 64),
    ("q_offset, window 100, kv_len < Sk", 1, 8, 4, 77, 400, True, 223, 300, 100),
    ("window 4096 biting", 1, 8, 4, 4200, 4200, True, 0, None, 4096),
]
ROUTES = ("tensor_core", "cuda_core")


def _live(sq, sk, causal, q_offset, kv_len, window):
    """[sq, sk]: whether query row i sees key j (the same for every head)."""
    kv_len = sk if kv_len is None else kv_len
    pos = q_offset + np.arange(sq)[:, None]
    keys = np.arange(sk)[None, :]
    live = np.broadcast_to(keys < kv_len, (sq, sk)).copy()
    if causal:
        live &= keys <= pos
    if window > 0:
        live &= keys > pos - window
    return live


def _brute(route, b, hq, hkv, sq, sk, causal, q_offset, kv_len, window):
    """{(kind, b, head, tile): the streamed tiles holding a live pair of the
    item's rows}, from the mask alone."""
    live = _live(sq, sk, causal, q_offset, kv_len, window)
    g, t = hq // hkv, fa.BWD256_TILE
    rows = fa.BWD256_ROWS[route]
    out = {}
    if route == "tensor_core":
        nq = -(-sq // t)
        tiles_q = [live[i * t:(i + 1) * t] for i in range(nq)]  # a query tile's rows
        for kt in range(-(-sk // rows)):
            keys = slice(kt * rows, (kt + 1) * rows)
            seen = [i for i in range(nq) if tiles_q[i][:, keys].any()]
            for bb in range(b):
                for hk in range(hkv):
                    out[(0, bb, hk, kt)] = seen
        for i in range(nq):
            seen = [j for j in range(-(-sk // t)) if tiles_q[i][:, j * t:(j + 1) * t].any()]
            for bb in range(b):
                for h in range(hq):
                    out[(1, bb, h, i)] = seen
        return out
    qpt, nsub = fa.packed_rows(sq, g)
    # each sub-tile's 64 packed rows as positions (-1 for padding)
    pos = np.full((nsub, fa.SUB_ROWS), -1)
    for s in range(nsub):
        for r in range(fa.SUB_ROWS):
            got = fa.packed_row(g, qpt, sq, s, r)
            if got is not None:
                pos[s, r] = got[1]

    def sees(positions, keys):
        positions = positions[positions >= 0]
        return bool(live[positions][:, keys].any()) if positions.size else False

    for kt in range(-(-sk // rows)):
        keys = slice(kt * rows, (kt + 1) * rows)
        seen = [s for s in range(nsub) if sees(pos[s], keys)]
        for bb in range(b):
            for hk in range(hkv):
                out[(0, bb, hk, kt)] = seen
    for half in range(2 * nsub):
        mine = pos[half // 2, (half % 2) * rows:(half % 2 + 1) * rows]
        seen = [j for j in range(-(-sk // t)) if sees(mine, slice(j * t, (j + 1) * t))]
        for bb in range(b):
            for hk in range(hkv):
                out[(1, bb, hk, half)] = seen
    return out


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_work_list_walks_exactly_the_live_tiles(case, route):
    _, b, hq, hkv, sq, sk, causal, q_offset, kv_len, window = case
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    blocks = fa.bwd256_order(route, b, hq, hkv, sq, sk, **kw)
    items = [it for blk in blocks for it in blk]
    want = _brute(route, b, hq, hkv, sq, sk, causal, q_offset, kv_len, window)
    # every item exactly once
    assert sorted(it[:4] for it in items) == sorted(want)
    g = hq // hkv
    for kind, bb, h, t, first, n in items:
        seen = want[(kind, bb, h, t)]
        per_head = n // g if route == "tensor_core" and kind == 0 else n
        if route == "tensor_core" and kind == 0:
            assert n % g == 0
        # the walk is the run of live tiles, no more and no fewer
        assert per_head == len(seen)
        if seen:
            assert seen == list(range(first, first + per_head))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_work_list_is_heaviest_first_and_balanced(case, route):
    _, b, hq, hkv, sq, sk, causal, q_offset, kv_len, window = case
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    blocks = fa.bwd256_order(route, b, hq, hkv, sq, sk, sms=132, **kw)
    items = [it for blk in blocks for it in blk]
    assert len(blocks) == min(132, len(items)) and all(blocks)
    for blk in blocks:
        w = [fa.bwd256_weight(it) for it in blk]
        assert w == sorted(w, reverse=True)
    loads = [sum(map(fa.bwd256_weight, blk)) for blk in blocks]
    heaviest = max(map(fa.bwd256_weight, items))
    assert max(loads) <= sum(loads) / len(loads) + heaviest
    # the same call gives the same list (the kernel's results depend on it)
    assert fa.bwd256_order(route, b, hq, hkv, sq, sk, sms=132, **kw) == blocks


def test_launch_shapes_leave_no_long_tail():
    """At the launch shapes the heaviest block ends within 3% (phase 10) and
    5% (phase 7) of the mean work a block; the two launches before left
    the dK/dV blocks of the first key tiles (72 and 66 units) beside means
    of 44 and 31."""
    for route, shape, slack in (("tensor_core", (4, 8, 4, 576, 576), 1.03), ("cuda_core", (2, 8, 4, 512, 512), 1.05)):
        blocks = fa.bwd256_order(route, *shape, causal=True, window=4096)
        loads = [sum(map(fa.bwd256_weight, blk)) for blk in blocks]
        assert max(loads) <= slack * sum(loads) / len(loads), (route, max(loads), sum(loads) / len(loads))


def test_kernels_a_call_launches():
    assert fa.bwd_kernels(256) == ("pre", "dkdv_dq")
    for d in (16, 32, 64, 128):
        assert fa.bwd_kernels(d) == ("pre", "dkdv", "dq")
    assert all(set(fa.bwd_kernels(d)) <= set(ks) for ks in fa.BWD_KERNELS.values() for d in (16, 64, 256))


#: (label, b, hq, hkv, sq, sk, causal, softcap, q_offset, kv_len, window):
#: the edges the kernels must cover, at head_dim 256
GRAD_CASES = [
    ("G 1, Sq 77, softcap", 1, 2, 2, 77, 77, True, 50.0, 0, None, 0),
    ("G 2, Sq 300, window 64", 1, 4, 2, 300, 300, True, 50.0, 0, None, 64),
    ("G 8, window 8", 1, 8, 1, 40, 40, True, 0.0, 0, None, 8),
    ("kv_len < Sk, not causal", 1, 4, 2, 48, 80, False, 0.0, 0, 60, 0),
    ("q_offset, kv_len < Sk", 1, 4, 2, 32, 150, True, 0.0, 100, 132, 0),
    ("q_offset, window, kv_len < Sk, softcap", 1, 4, 2, 37, 200, True, 50.0, 111, 148, 40),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_plain_backward_at_256_matches_jax_grad(case):
    """attention_backward_plain (the version the kernels are held to on the
    card) on the plain forward's output and lse, against jax.grad of the
    JAX package's chunked_attention on the same numpy inputs; q scaled by 8
    so the softcap's bend shows."""
    _, b, hq, hkv, sq, sk, causal, cap, q_offset, kv_len, window = case
    rng = np.random.default_rng(sq + sk + window)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in ((b, hq, sq, 256), (b, hkv, sk, 256), (b, hkv, sk, 256), (b, hq, sq, 256)))
    q = q * np.float32(8.0)
    kw = dict(causal=causal, softcap=cap, q_offset=q_offset, kv_len=kv_len, window=window)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out = fa.attention_plain(tq, tk, tv, **kw)
    lse = fa.attention_lse_plain(tq, tk, **kw)
    got = fa.attention_backward_plain(tq, tk, tv, out, lse, tdo, **kw)

    def loss(q, k, v):
        o = chunked_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                              kv_len=None if kv_len is None else jnp.asarray(kv_len), attn_softcap=cap, block_k=32)
        return jnp.sum(o * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        err = float(np.max(np.abs(g.numpy() - w)))
        assert err <= TOL * float(np.max(np.abs(w))), (name, err / float(np.max(np.abs(w))))
    if kv_len is not None:  # keys past kv_len get no gradient on either side
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()
