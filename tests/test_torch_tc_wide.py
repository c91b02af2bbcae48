"""The tensor-core forward's wide plans, (192, 128) and (256, 256), on the CPU.

Their kernel (``flash_tc_wide_kernel`` in ``csrc/flash_attention_tc.cu``)
runs only on the card; here: its softcap arithmetic (``softcap_log2_plain``,
scores in log2 units) against the Pallas kernel's own ``c * jnp.tanh(s /
c)`` on a dense grid and inside a whole attention against the Pallas
kernel in interpret mode; its work list (``tc_wide_order``, the host copy)
at the served shapes and at ragged Sq; and the routes of the wide shapes.
Inputs come from numpy with a seed.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402

LN2 = math.log(2.0)
#: the softcapped score's error the backward's recomputation (tanhf) can
#: take, as a share of c; the kernel's bound (its source's header) is 4.5e-7
SOFTCAP_TOL = 1e-6


def _grid(c: float) -> np.ndarray:
    """Raw scores: 0, +-1e-8, +-c, +-1e4, the -1e30 mask and a dense sweep
    through tanh's bend and its saturation."""
    dense = np.concatenate([np.linspace(-8 * c, 8 * c, 20001), np.geomspace(1e-8, 1e6, 2001)])
    return np.concatenate([[0.0, 1e-8, -1e-8, c, -c, 1e4, -1e4, -1e30], dense, -dense]).astype(np.float32)


@pytest.mark.parametrize("c", [50.0, 30.0])
def test_softcap_arithmetic_equals_the_pallas_kernels_tanh(c):
    """``c2 - 2 c2 / (2^(s k) + 1)`` in f32 against ``c * jnp.tanh(s / c)``
    (src/repro/kernels/flash_attention/kernel.py:69), in f32. Worst error
    here, with exp2 and the reciprocal correctly rounded: 3.6e-7 c at c = 50
    (s = -237) and 3.8e-7 c at c = 30 (s = -156), where t nears -1 and the
    rounding of 2 r near 2 shows; the card's ex2.approx and rcp.approx are
    measured against tanh by test_torch_gpu.py's softcap test."""
    s = _grid(c)
    want = np.asarray(c * jnp.tanh(jnp.asarray(s) / c), dtype=np.float64)
    got = fa.softcap_log2_plain(torch.from_numpy(s), c).double().numpy() * LN2
    err = np.abs(got - want)
    assert np.isfinite(got).all()
    assert err.max() <= SOFTCAP_TOL * c, (err.max() / c, s[err.argmax()])
    # saturation and the mask: exactly +-c2 back, and 0 to 0
    sat = fa.softcap_log2_plain(torch.tensor([1e4, -1e4, -1e30, 0.0]), c)
    c2 = torch.tensor(c * 1.4426950408889634, dtype=torch.float32)
    assert torch.equal(sat, torch.stack([c2, -c2, -c2, torch.zeros(())]))


def _attention_log2(q, k, v, c: float, causal: bool):
    """A plain f32 attention on the wide plans' arithmetic: softcapped
    scores in log2 units, 2^(s2 - m2), the -1e30 mask after the softcap."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qf = q.reshape(b, hkv, hq // hkv, sq, d)
    dots = torch.einsum("bhgqd,bhkd->bhgqk", qf, k)
    s2 = fa.softcap_log2_plain(dots, c, scale=1.0 / math.sqrt(d)) if c > 0 else dots * (1.0 / math.sqrt(d)) / LN2
    if causal:
        mask = torch.ones(sq, k.shape[2], dtype=torch.bool).tril()
        s2 = s2.masked_fill(~mask, fa.NEG_INF)
    p = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhgqk,bhkd->bhgqd", p / p.sum(dim=-1, keepdim=True), v)
    return out.reshape(b, hq, sq, v.shape[3])


#: (b, hq, hkv, sq, d, causal, softcap): gemma2's group of 2 and softcap 50
ATTN_CASES = [(1, 4, 2, 96, 64, True, 50.0), (1, 2, 2, 64, 32, False, 30.0), (2, 2, 1, 48, 32, True, 0.0)]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_log2_softcap_attention_equals_pallas_interpret(case):
    """The attention as the wide kernel computes it (in f32) against the
    Pallas kernel in interpret mode, f32 tolerance 2e-5."""
    b, hq, hkv, sq, d, causal, c = case
    rng = np.random.default_rng(sq * 7 + d)
    # scores of several c: the softcap bends them
    q = (rng.standard_normal((b, hq, sq, d)) * 4).astype(np.float32)
    k = (rng.standard_normal((b, hkv, sq, d)) * 4).astype(np.float32)
    v = rng.standard_normal((b, hkv, sq, d)).astype(np.float32)
    got = _attention_log2(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), c, causal)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, softcap=c, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# -- the work list ---------------------------------------------------------------------------------------------


#: (label, (b, hq, hkv, sq, causal, window)): phase 12's MLA prefill, phase
#: 9's gemma2 prefill (windowed and global), phase 10's training forward,
#: and ragged Sq at the item edges
ORDER_CASES = [
    ("phase 12 MLA prefill", (4, 128, 128, 512, True, 0)),
    ("phase 9 gemma2 windowed", (4, 8, 4, 4608, True, 4096)),
    ("phase 9 gemma2 global", (4, 8, 4, 4608, True, 0)),
    ("phase 10 training forward", (4, 8, 4, 576, True, 4096)),
    ("Sq 77", (2, 16, 16, 77, True, 0)),
    ("Sq 127, G 4", (1, 32, 8, 127, True, 0)),
    ("Sq 129", (2, 16, 16, 129, True, 0)),
    ("Sq 255", (1, 56, 8, 255, True, 64)),
    ("Sq 257, head-major", (2, 64, 64, 257, True, 0)),
    ("Sq 511, not causal", (2, 16, 16, 511, False, 0)),
    ("Sq 513, not causal, window", (1, 64, 64, 513, False, 100)),
    ("Sq 4200", (1, 8, 4, 4200, True, 4096)),
    ("one item", (1, 1, 1, 100, True, 0)),
]


def _items(case):
    b, hq, hkv, sq, causal, window = case
    return fa.tc_wide_order(b, hq, hkv, sq, causal=causal, window=window)


def _positions(order):
    """(round, block, item) of every item; the grid is len(order)."""
    grid = len(order)
    return [(r, i, it) for i, items in enumerate(order) for r, it in enumerate(items)], grid


@pytest.mark.parametrize("label,case", ORDER_CASES, ids=[c[0] for c in ORDER_CASES])
def test_work_list_takes_every_item_once(label, case):
    b, hq, hkv, sq, causal, window = case
    order = _items(case)
    nq = -(-sq // fa.TC_WIDE_ROWS)
    got = sorted(it for items in order for it in items)
    assert got == sorted((bb, h, j) for bb in range(b) for h in range(hq) for j in range(nq))
    assert len(order) == min(132, b * hq * nq)
    # round r of block i is position r G + (i, or G - 1 - i in odd rounds):
    # every round but the last is full
    counts = [len(items) for items in order]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("label,case", ORDER_CASES, ids=[c[0] for c in ORDER_CASES])
def test_items_that_share_kv_run_in_one_wave(label, case):
    """Head-major lists (G x group < 2 B Hq: MLA's heads of their own K/V)
    put a head's query tiles in one round, or two at a round's edge, within
    one wave of positions; tile-major lists (G x group >= 2 B Hq: gemma2)
    put at least two items on each K/V head a round reads."""
    b, hq, hkv, sq, causal, window = case
    order = _items(case)
    (pos, grid), nq = _positions(order), -(-sq // fa.TC_WIDE_ROWS)
    group = hq // hkv
    if grid * group < 2 * b * hq:
        where = {}
        for r, i, (bb, h, _) in pos:
            where.setdefault((bb, h), []).append(r * grid + (grid - 1 - i if r % 2 else i))
        for head, ps in where.items():
            assert len(ps) == nq
            assert max(ps) - min(ps) < grid + nq, (head, ps)
            assert max(ps) // grid - min(ps) // grid <= 1
    elif b * hq * nq > 1:
        per_round = {}
        for r, _, (bb, h, _) in pos:
            per_round.setdefault(r, {}).setdefault((bb, h // group), 0)
            per_round[r][(bb, h // group)] += 1
        full_rounds = [r for r in per_round if sum(per_round[r].values()) == grid]
        for r in full_rounds:
            assert min(per_round[r].values()) >= 2, (r, per_round[r])


def test_phase_12_heads_run_side_by_side():
    """At MLA's served prefill every head's four query tiles run in the same
    round: their K/V is read from HBM once."""
    order = fa.tc_wide_order(4, 128, 128, 512)
    rounds = {}
    for items in order:
        for r, (bb, h, _) in enumerate(items):
            rounds.setdefault((bb, h), set()).add(r)
    assert all(len(rs) == 1 for rs in rounds.values())


def _live_tiles(sq, j, causal, window, rows=fa.TC_WIDE_ROWS):
    q0, last = j * rows, min(sq, j * rows + rows) - 1
    end = min(sq, last + 1) if causal else sq
    start = max(0, q0 - window + 1) if window > 0 else 0
    return -(-end // 64) - start // 64


def _makespan(order, sq, causal, window):
    return max(sum(_live_tiles(sq, j, causal, window) + 1 for _, _, j in items) for items in order)


@pytest.mark.parametrize("label,case", ORDER_CASES[:4], ids=[c[0] for c in ORDER_CASES[:4]])
def test_work_list_balances_the_blocks(label, case):
    """Each block's key tiles (plus one an item) at the served shapes: the
    snake keeps the busiest block no busier than under the plain tile-major
    round robin of the same items, and within 12% of the mean."""
    b, hq, hkv, sq, causal, window = case
    order = _items(case)
    nq, nbh, grid = -(-sq // fa.TC_WIDE_ROWS), b * hq, len(order)
    plain = [[] for _ in range(grid)]
    for u in range(nq * nbh):
        plain[u % grid].append((u % nbh // hq, u % nbh % hq, nq - 1 - u // nbh))
    span = _makespan(order, sq, causal, window)
    assert span <= _makespan(plain, sq, causal, window)
    total = sum(_live_tiles(sq, j, causal, window) + 1 for items in order for _, _, j in items)
    assert span <= 1.12 * total / grid + max(_live_tiles(sq, j, causal, window) + 1 for j in range(nq)) * (
        nbh * nq < 2 * grid)


@pytest.mark.parametrize("shape", [(4, 128, 128, 512, 192, 128), (4, 8, 4, 4608, 256, 256), (4, 8, 4, 576, 256, 256),
                                   (1, 16, 16, 77, 192, 128), (1, 8, 4, 129, 256, 256)])
def test_wide_shapes_take_the_tensor_core_route(shape):
    b, hq, hkv, sq, d, dv = shape
    q = torch.empty((b, hq, sq, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, hkv, sq, d), dtype=torch.bfloat16, device="meta")
    v = torch.empty((b, hkv, sq, dv), dtype=torch.bfloat16, device="meta")
    assert fa._route(q, k, v=v) == "tensor_core"
    assert fa._route(q, k, v=v, grad=True) == "tensor_core"
