"""Flash attention on the device: the attention of the decoder's prefill
and decode.

``flash_attention(q, k, v, causal=, softcap=, q_offset=, kv_len=, window=)``
takes q ``[B, Hq, Sq, D]``, k ``[B, Hkv, Sk, D]`` and v ``[B, Hkv, Sk,
Dv]`` (the JAX wrapper's layout, ``repro/kernels/flash_attention/ops.py``;
``Dv`` is ``D`` but for MLA's expanded form, q/k 192 and v 128, as the JAX
models' ``chunked_attention`` allows) and returns ``[B, Hq, Sq, Dv]`` in
q's dtype:

    s   = (q . k) / sqrt(D)               in f32
    s   = softcap * tanh(s / softcap)      when softcap > 0
    s   = -1e30 where key j >= kv_len, or (causal) j > q_offset + i,
          or (window > 0) j <= q_offset + i - window
    out = softmax(s) @ v

with GQA (query head h reads KV head ``h // (Hq // Hkv)``, no copy of K or
V). ``q_offset`` places query row 0 in the sequence and ``kv_len`` is the
number of valid keys (default ``Sk``): a decode step passes the cache
length and a cache of ``max_len`` slots. ``window`` is the sliding window
of gemma2's local layers, as the JAX package's ``_block_mask``
(``repro/models/layers.py``): key j is visible to the query at position p
only if ``j > p - window``; ``window <= 0`` is unlimited. Every query row
must see a key, so a window that ends before ``kv_len`` for the last row
is refused. With the defaults it computes what the Pallas kernel
``flash_attention_bh`` (``repro/kernels/flash_attention/kernel.py``)
computes; the Pallas kernel has no window (the JAX model's windowed layers
run the jnp ``chunked_attention``).

On a CUDA tensor it launches one of three hand-written kernels or raises;
the route follows from dtype and shape alone (:func:`_route`), never from
a failure:

* ``"decode"`` (``csrc/flash_decode.cu``): every call whose packed query
  rows fit one tile, ``Sq * G <= 64`` (``G = Hq / Hkv``), in f32 or bf16
  at head_dim 64/80/128/256 (80 in instances of its own, zamba2's decode
  and ring decode). The key range is cut into splits
  (:func:`split_plan`), one block a (batch, KV head, split), and the
  block that finishes a (batch, KV head)'s last split merges the splits'
  partial softmax states (what :func:`split_kv_plain` computes in plain
  PyTorch).
* ``"tensor_core"`` (``csrc/flash_attention_tc.cu``): the rest in bf16 at
  head_dim 64, 80, 128 or 256 (the prefill, gemma2's at 256, hubert's
  encoder at 80), and every bf16 call at (D, Dv) = (192, 128)
  (deepseek-v3's expanded MLA prefill): TMA loads and ``wgmma`` on the
  tensor cores (``TC_DIM_PAIRS``). Head_dim 80 runs the head_dim-128 plan,
  its tensor maps at the true width (TMA fills columns 80-127 with zeros,
  the output's store clips at 80). The two
  wide pairs, (192, 128) and (256, 256), run a kernel of their own: 128-row
  items in a work list whose host copy is :func:`tc_wide_order`, two
  warpgroups taking turns at the tensor cores, and the softcap in log2
  units (:func:`softcap_log2_plain`).
* ``"f32"`` (``csrc/flash_attention.cu``): everything else, f32, bf16 or
  f16 at head_dim 16/32/64/80/128/256 and at (D, Dv) = (24, 16) (the
  reduced deepseek-v3's MLA, run on the head_dim-32 tiles with the columns
  past the true widths zero; head_dim 80 likewise on the head_dim-128
  tiles), in f32 FMAs on the CUDA cores,
  ``Hq / Hkv <= 64``: K/V tiles through a two-stage ``cp.async`` ring,
  128 packed query rows a block (:func:`packed_rows`), 8 x 8 micro-tiles
  a thread for the scores (each half of the block over half of D) and for
  P V.

Every forward route takes the window: a block (a split, on ``decode``)
walks only the key tiles from its first visible key (:func:`live_start`)
to its last, and masks the window's edge per element as it masks the
causal one.

Other head_dims (96, 192 with a v of 192, ...) are refused on the card,
and so is every Dv != D but (192, 128) and (24, 16), with the route and
the shape named. The scale is ``1/sqrt(D)``
of q/k's true width, never a tile's.

On a CPU tensor it runs :func:`attention_plain`, the plain PyTorch version
(naive f32 softmax, as the JAX package's ``ref.py:attention_ref`` and
``layers.py:reference_attention``) that the kernels are held against, and
launches nothing. ``LAUNCHES`` counts every launch of a route,
``ROUTE_LAUNCHES[route]`` each route's.

Every route's output lies in memory as ``[B, Sq, Hq, D]`` under the
``[B, Hq, Sq, D]`` view it returns, so merging the heads afterwards is a
view, not a copy.

The gradient. When autograd wants one (grad mode on and q, k or v
requiring it), the call goes through a ``torch.autograd.Function``: the
forward runs on the ``tensor_core`` route (bf16 at head_dim 64/80/128/256
and at (192, 128)) or the ``f32`` route (the rest), never on ``decode``, and
also writes each
row's log-sum-exp (``m + log(max(l, 1e-30))``, f32 ``[B, Hq, Sq]``). The
backward (:func:`launch_backward`) takes one of two routes, again by dtype
and shape alone (:func:`_bwd_route`), both with or without a window:

* ``"tensor_core"`` (``csrc/flash_attention_bwd_tc.cu``): bf16 at (D, Dv)
  in ``TC_DIM_PAIRS`` (head_dim 64/80/128/256, and deepseek-v3's expanded
  MLA at (192, 128)), the training step's path. Three kernels at head_dim
  64/80/128 (80 on the 128 kernels, as the forward):
  ``pre`` (``D_i = rowsum(dO * O)``), ``dkdv`` (one block 128 keys) and
  ``dq`` (one block 128 query rows), with ``wgmma`` products fed by TMA.
* ``"cuda_core"`` (``csrc/flash_attention_bwd.cu``): f32, f16 and bf16 at
  head_dim 16/32/64/80/128/256 and at (24, 16) otherwise, in f32 FMAs.
  Three kernels at head_dim 16-128 and at (24, 16) (the head_dim-32
  kernels with the columns past the true widths zero; 80 likewise on the
  head_dim-128 kernels): ``pre`` (``D_i`` and the lse into a stats scratch in
  packed-row order), ``dkdv`` (64 keys a block; Q/dO sub-tiles through a
  two-stage ``cp.async`` ring) and ``dq`` (128 packed query rows a block;
  K/V tiles through the ring).

At head_dim 256 both routes, and the ``tensor_core`` route at (192, 128),
launch ``pre`` and then one persistent kernel, ``dkdv_dq``, that walks the
dK/dV items (keys of a KV head) and the dQ items (query rows;
``BWD256_ROWS`` a item) of the call in one work list, heaviest first, each
block's share assigned on the host (:func:`bwd256_order`, cached on the
device by shape): :func:`bwd_kernels` names what a call launches.

``BWD_LAUNCHES["<route>/<kernel>"]`` counts each kernel's launches. On the
CPU the same ``Function`` runs :func:`attention_plain` and
:func:`attention_backward_plain` at any head_dim. The JAX package has no
Pallas backward: it differentiates its jnp ``chunked_attention``. On the
card the backward refuses the (q/k, v) pairs no kernel takes
(:func:`_check_backward`: a head_dim none of the lists holds, (192, 128)
in f32 or f16, every other Dv != D), naming the pair; nothing falls back
to another route.
"""

from __future__ import annotations

import ctypes
import math
import sys
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: kernel dtype codes (csrc/flash_attention.cu, csrc/flash_decode.cu,
#: csrc/flash_attention_bwd.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 80, 128, 256)  # the decode route's
DECODE_DTYPES = (torch.float32, torch.bfloat16)
TC_HEAD_DIMS = (64, 80, 128, 256)  # the tensor-core routes', forward and backward (bf16)
#: the (q/k, v) head_dims the tensor-core forward and backward take (bf16):
#: their plans (csrc/flash_attention_tc.cu, csrc/flash_attention_bwd_tc.cu;
#: 80 on the 128 plans), deepseek-v3's expanded MLA last
TC_DIM_PAIRS = ((64, 64), (80, 80), (128, 128), (256, 256), (192, 128))
#: the Dv != D pairs the CUDA-core routes take (the f32 forward and the
#: cuda_core backward, f32, bf16 and f16): the reduced deepseek-v3's MLA,
#: q/k 16 + 8 and v 16, on the head_dim-32 kernels
CC_DIM_PAIRS = ((24, 16),)
F32_HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # the f32 route's (f32, bf16, f16; 80 on the 128 tiles)
MAX_GROUP = 64  # the f32 route packs a KV group's query heads into one 64-row tile
DECODE_ROWS = 64  # packed query rows (Sq * G) the decode route takes
ROUTES = ("decode", "tensor_core", "f32")
TILE_KEYS = 64  # keys a tile of the decode kernel, and the unit of a split
MAX_SPLIT_BLOCKS = 640  # decode grid: about one wave of the kernel (5 blocks an SM of 132)
MAX_SPLITS = 64

BWD_HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # the cuda_core backward's (f32, bf16, f16; 80 on the 128 kernels)
TC_BWD_TILE = 64  # query rows a tile of the tensor_core backward (its stats scratch comes in tiles)
#: the backward's routes and each one's kernels (:func:`bwd_kernels` names
#: those a call launches, in order)
BWD_KERNELS = {"tensor_core": ("pre", "dkdv", "dq", "dkdv_dq"), "cuda_core": ("pre", "dkdv", "dq", "dkdv_dq")}
#: the (q/k, v) pairs whose backward walks its dK/dV and dQ items in one
#: launch (both routes at 256, the tensor-core route at deepseek-v3's (192,
#: 128))
BWD_ONE_LAUNCH_PAIRS = ((256, 256), (192, 128))
#: the head_dim-256 backwards' item rows by route: keys a dK/dV item and
#: query rows a dQ item (packed rows on ``cuda_core``), and the rows of the
#: tiles an item streams (query tiles of 64 rows or sub-tiles of 64 packed
#: rows, key tiles of 64)
BWD256_ROWS = {"tensor_core": 64, "cuda_core": 32}
BWD256_TILE = 64

#: the CUDA-core kernels' query rows come in sub-tiles of SUB_ROWS packed
#: rows (:func:`packed_rows`; csrc/vec.cuh)
SUB_ROWS = 64

#: launches of any route's kernel, and of each route's (bumped only where
#: the kernel is launched)
LAUNCHES = build.LaunchCount()
ROUTE_LAUNCHES = {r: build.LaunchCount() for r in ROUTES}
#: launches of each backward kernel, by "<route>/<kernel>"
BWD_LAUNCHES = {f"{r}/{k}": build.LaunchCount() for r, ks in BWD_KERNELS.items() for k in ks}


def _check(q, k, v, softcap: float, q_offset: int, kv_len: Optional[int], window: int = 0) -> int:
    """Validate the call; return the effective ``kv_len``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"flash_attention: want q [B,Hq,Sq,D], k [B,Hkv,Sk,D], v [B,Hkv,Sk,Dv] (k = v in B, Hkv, Sk), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, _, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} must be a multiple of Hkv={hkv}")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: want float32, bfloat16 or float16 throughout, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one device")
    kv_len = sk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [1, {sk}]")
    if int(q_offset) < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if softcap < 0:
        raise ValueError(f"flash_attention: softcap {softcap} < 0")
    if int(window) > 0 and int(q_offset) + q.shape[2] - int(window) >= kv_len:
        raise ValueError(f"flash_attention: window {window} leaves the query at position "
                         f"{int(q_offset) + q.shape[2] - 1} no key below kv_len {kv_len}")
    return kv_len


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
    with_lse: bool = False,
):
    """Plain PyTorch version on any device: the whole score matrix in f32,
    masked with -1e30, a softmax, and the product with v (GQA by grouping
    the query heads, without repeating K/V). With ``with_lse`` it returns
    ``(out, lse)``, the lse :func:`attention_lse_plain`'s."""
    kv_len = _check(q, k, v, softcap, q_offset, kv_len, window)
    b, hq, sq, _ = q.shape
    s, _, _ = _scores_plain(q, k, causal, softcap, q_offset, kv_len, window)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out.reshape(b, hq, sq, v.shape[3]).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1).reshape(b, hq, sq)) if with_lse else out


def _mask(sq: int, kpos: torch.Tensor, causal: bool, q_offset: int, kv_len: int, window: int) -> torch.Tensor:
    """``[Sq, len(kpos)]``: True where query row i (at position q_offset +
    i) may see the key at position ``kpos[j]``, the JAX package's
    ``_block_mask``."""
    mask = (kpos < kv_len)[None, :]
    if causal or int(window) > 0:
        qpos = int(q_offset) + torch.arange(sq, device=kpos.device)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if int(window) > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - int(window))
    return mask


def _scores_plain(q, k, causal: bool, softcap: float, q_offset: int, kv_len: int, window: int = 0):
    """The f32 scores ``[B, Hkv, G, Sq, Sk]`` masked with -1e30, the mask,
    and (with a softcap) ``tanh(s / softcap)`` of the unmasked scores."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * (1.0 / math.sqrt(d))
    t = None
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mask = _mask(sq, torch.arange(sk, device=q.device), causal, q_offset, kv_len, window)
    return s.masked_fill(~mask, NEG_INF), mask, t


def attention_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
) -> torch.Tensor:
    """Each query row's log-sum-exp of its masked scores, f32 ``[B, Hq,
    Sq]``: what the forward kernels write for the backward."""
    kv_len = _check(q, k, k, softcap, q_offset, kv_len, window)
    b, hq, sq, _ = q.shape
    s, _, _ = _scores_plain(q, k, causal, softcap, q_offset, kv_len, window)
    return torch.logsumexp(s, dim=-1).reshape(b, hq, sq)


def attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash-attention backward in plain PyTorch, f32, written out
    (the algorithm of the backward kernels): P recomputed from the scores
    and the forward's log-sum-exp, ``P = exp(s - lse)``; ``dV = P^T dO``,
    ``dP = dO V^T``, ``D = rowsum(dO * O)``, ``dS = P * (dP - D)``, times
    ``1 - (s_c / c)^2`` under a softcap c; ``dQ = dS K * scale``, ``dK =
    dS^T Q * scale``; dK and dV summed over the G query heads of each KV
    head (no copy of K or V). Returns ``(dq, dk, dv)`` in the inputs'
    dtype."""
    kv_len = _check(q, k, v, softcap, q_offset, kv_len, window)
    b, hq, sq, d = q.shape
    hkv, vd = k.shape[1], v.shape[3]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    s, _, t = _scores_plain(q, k, causal, softcap, q_offset, kv_len, window)
    p = torch.exp(s - lse.float().reshape(b, hkv, g, sq, 1))
    do = dout.float().reshape(b, hkv, g, sq, vd)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do, v.float())
    rows = (do * out.float().reshape(b, hkv, g, sq, vd)).sum(dim=-1, keepdim=True)
    ds = p * (dp - rows)
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, q.float().reshape(b, hkv, g, sq, d)) * scale
    return dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def packed_rows(sq: int, group: int) -> Tuple[int, int]:
    """``(qpt, nsub)`` of the CUDA-core kernels' packed query rows: the G
    query heads of a KV head share its K and V, so a sub-tile of
    ``SUB_ROWS`` rows holds ``qpt = 64 // G`` positions x the G heads and
    ``nsub`` sub-tiles cover ``Sq`` positions (csrc/vec.cuh ``packed_row``)."""
    qpt = SUB_ROWS // group
    return qpt, -(-sq // qpt)


def packed_row(group: int, qpt: int, sq: int, sub: int, r: int) -> Optional[Tuple[int, int]]:
    """``(head in group, position)`` of row ``r`` of sub-tile ``sub``, or
    None for a padding row: what ``packed_row`` in csrc/vec.cuh computes."""
    pos = sub * qpt + r // group
    return (r % group, pos) if r < qpt * group and pos < sq else None


#: query rows a work item of the tensor-core forward's wide plans, (192,
#: 128) and (256, 256): two consumer warpgroups of 64 (csrc/flash_attention_tc.cu)
TC_WIDE_ROWS = 128


def tc_wide_order(batch: int, hq: int, hkv: int, sq: int, *, causal: bool = True, window: int = 0,
                  sms: int = 132) -> list:
    """The wide plans' work list, as ``flash_tc_wide_kernel`` walks it:
    for each persistent block, its items ``(b, h, query tile)`` in order.
    Block ``i`` takes, in round ``r``, position ``r G + i`` (``r G + G - 1
    - i`` in odd rounds: the snake) of a list sorted heaviest first (the
    most live key tiles: the last query tiles when causal or unwindowed)
    within windows: the whole list (the tile-major order) when a round of it
    puts two or more items on each K/V head it reads (``G x group >= 2 B
    Hq``), else one round of items listed head by head, so a head's query
    tiles run side by side in one round (``wide_work`` and ``wide_pos`` in
    the CUDA source)."""
    nq = -(-sq // TC_WIDE_ROWS)
    nbh = batch * hq
    nwork = nq * nbh
    grid = min(nwork, sms)
    group = hq // hkv
    last_first = causal or window <= 0
    head_major = grid * group < 2 * nbh

    def item(u: int):
        if not head_major:
            bh, jj = u % nbh, u // nbh
            j = nq - 1 - jj if last_first else jj
        else:
            v0 = u - u % grid
            v1 = min(v0 + grid, nwork)
            s = u - v0
            for i in range(nq):
                j = nq - 1 - i if last_first else i
                count = (v1 + nq - 1 - j) // nq - (v0 + nq - 1 - j) // nq
                if s < count:
                    bh = (v0 + (j - v0 % nq) % nq) // nq + s
                    break
                s -= count
        return bh // hq, bh % hq, j

    rounds = -(-nwork // grid)
    blocks = []
    for i in range(grid):
        pos = (r * grid + (grid - 1 - i if r % 2 else i) for r in range(rounds))
        blocks.append([item(u) for u in pos if u < nwork])
    return blocks


def softcap_log2_plain(s: torch.Tensor, softcap: float, scale: float = 1.0) -> torch.Tensor:
    """The wide plans' softcapped score in log2 units, ``log2(e) c tanh(x
    scale / c)`` for raw dots ``s``, with their arithmetic in f32 (constants
    folded in double, rounded once): ``c2 - 2 c2 / (2^(s k) + 1)``, ``c2 = c
    log2 e``, ``k = 2 log2 e scale / c``. The kernel takes 2^y and the
    reciprocal to within 2^-22 and an ulp (``ex2.approx``,
    ``rcp.approx``) where this takes them correctly rounded."""
    log2e = 1.4426950408889634
    k = torch.tensor(2.0 * log2e * scale / softcap, dtype=torch.float32)
    c2 = torch.tensor(softcap * log2e, dtype=torch.float32)
    r = torch.reciprocal(torch.exp2(s.float() * k) + 1.0)
    return torch.addcmul(c2, r, -2.0 * c2)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if every route can read its rows in place, else a contiguous
    copy: unit stride in D, and a 16-byte aligned base and batch, head and
    sequence strides (TMA's rule for its tensor maps, and the 16-byte
    vector loads and ``cp.async`` of the other kernels), none of them 0 (a
    broadcast gradient); a dimension of extent 1 may have any stride. A
    copy, not ``contiguous()``: a contiguous view at a misaligned offset
    needs new storage too."""
    unit = 16 // t.element_size()
    st, n = t.stride(), t.shape
    ok = st[3] == 1 and t.data_ptr() % 16 == 0 and all((st[i] % unit == 0 and st[i] > 0) or n[i] == 1
                                                         for i in range(3))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _route(q: torch.Tensor, k: torch.Tensor, grad: bool = False, v: Optional[torch.Tensor] = None) -> str:
    """The kernel a call goes to, from dtype and shape alone: ``decode``
    for a decode-sized call in f32 or bf16 at head_dim 64/80/128/256,
    ``tensor_core`` for bf16 at head_dim 64/80/128/256 and for every bf16 call
    at (D, Dv) = (192, 128) (v's head_dim ``Dv`` is D unless ``v`` is
    given), ``f32`` for the rest. A call that needs a gradient (``grad``)
    never goes to ``decode``: only the other two forwards write the
    log-sum-exp the backward reads. Dv != D goes to ``tensor_core`` for bf16
    at (192, 128) and to ``f32`` otherwise, which takes (24, 16) and
    refuses any other pair."""
    _, hq, sq, d = q.shape
    vd = d if v is None else v.shape[3]
    if vd != d:
        return "tensor_core" if q.dtype == torch.bfloat16 and (d, vd) in TC_DIM_PAIRS else "f32"
    small = sq * (hq // k.shape[1]) <= DECODE_ROWS
    if not grad and small and q.dtype in DECODE_DTYPES and d in HEAD_DIMS:
        return "decode"
    if q.dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "tensor_core"
    return "f32"


def _bwd_route(q: torch.Tensor, v: Optional[torch.Tensor] = None) -> str:
    """The backward's route, from dtype and shape alone: ``tensor_core``
    for bf16 at a (q/k, v) head_dim pair of ``TC_DIM_PAIRS`` (v's
    head_dim is q's unless ``v`` is given), ``cuda_core`` for the rest."""
    d = q.shape[-1]
    pair = (d, d if v is None else v.shape[-1])
    return "tensor_core" if q.dtype == torch.bfloat16 and pair in TC_DIM_PAIRS else "cuda_core"


def bwd_kernels(d: int, dv: Optional[int] = None) -> Tuple[str, ...]:
    """The kernels a backward call at (q/k, v) head_dims ``(d, dv)`` (``dv``
    defaults to ``d``) launches, in order: ``pre``, then ``dkdv`` and
    ``dq``, or at a pair of ``BWD_ONE_LAUNCH_PAIRS`` the one launch of both,
    ``dkdv_dq``."""
    pair = (d, d if dv is None else dv)
    return ("pre", "dkdv_dq") if pair in BWD_ONE_LAUNCH_PAIRS else ("pre", "dkdv", "dq")


def bwd256_items(route: str, batch: int, hq: int, hkv: int, sq: int, sk: int, *, causal: bool = True,
                 q_offset: int = 0, kv_len: Optional[int] = None, window: int = 0) -> list:
    """Every item of a head_dim-256 backward call, ``(kind, b, head, tile,
    first, n)``, as the ``dkdv_dq`` kernels walk them: the streamed tiles
    ``first .. first + n - 1`` (dK/dV on ``tensor_core``: ``n`` is G times
    the query tiles, walked head by head).
    Kind 0, dK/dV: a KV head's ``BWD256_ROWS[route]`` keys from ``tile``
    times that, and the query tiles (``tensor_core``: 64 rows of each of the
    G heads; ``cuda_core``: sub-tiles of 64 packed rows, :func:`packed_rows`)
    whose rows see one of them. Kind 1, dQ: ``tensor_core``, 64 rows of a
    query head from ``64 tile``; ``cuda_core``, 32 packed rows of a KV head,
    half ``tile % 2`` of sub-tile ``tile // 2``; and the key tiles of 64
    holding a key one of its rows sees. Both from the first tile's causal or
    window edge to the last's. Every dK/dV item is listed, even one with no
    live tile (it writes its keys' zeros), and so is every dQ item (one of
    padding rows alone has none)."""
    kv_len = sk if kv_len is None else int(kv_len)
    rows, t = BWD256_ROWS[route], BWD256_TILE
    g = hq // hkv
    win = int(window) if window > 0 else 1 << 30
    cc = route == "cuda_core"
    qpt, nsub = packed_rows(sq, g) if cc else (t, -(-sq // t))  # positions a query tile, query tiles
    items = []
    for b in range(batch):
        for hk in range(hkv):
            for kt in range(-(-sk // rows)):
                k0 = kt * rows
                first = max(0, k0 - q_offset) // qpt if causal else 0
                last = min(k0 + rows, kv_len) - 1 + win - 1 - q_offset  # the last position whose window reaches it
                end = nsub if window <= 0 else (0 if last < 0 else min(nsub, last // qpt + 1))
                n = max(end - first, 0) if k0 < kv_len else 0
                items.append((0, b, hk, kt, first, n if cc else g * n))
        for h in range(hkv if cc else hq):
            for qt in range(2 * nsub if cc else nsub):
                if cc:  # the positions of packed rows [r0, r0 + 32) of sub-tile qt // 2
                    r0, live_rows = (qt % 2) * rows, qpt * g
                    p0 = (qt // 2) * qpt + r0 // g
                    p1 = min(sq - 1, (qt // 2) * qpt + (min(r0 + rows, live_rows) - 1) // g)
                    if r0 >= live_rows or p0 >= sq:
                        items.append((1, b, h, qt, 0, 0))
                        continue
                else:
                    p0, p1 = qt * t, min(sq, (qt + 1) * t) - 1
                kv_end = min(kv_len, q_offset + p1 + 1) if causal else kv_len
                t0 = max(0, q_offset + p0 - win + 1) // t if window > 0 else 0
                items.append((1, b, h, qt, t0, -(-kv_end // t) - t0))
    return items


def bwd256_weight(item, dims: Tuple[int, int] = (256, 256)) -> float:
    """An item's work in products of its rows x a tile's 64 x 256 at the
    (q/k, v) head_dims ``dims``: a live tile of a dK/dV item takes S^T and
    dK over q/k's width and dP^T and dV over v's, a dQ item's S and dQ over
    q/k's and dP over v's; and the epilogue writes dK and dV (dQ). At (256,
    256) that is four (three) a tile and two (one) for the epilogue."""
    kind, n = item[0], item[5]
    d, dv = dims
    return (2 * (d + dv) * n + d + dv) / 256 if kind == 0 else ((2 * d + dv) * n + d) / 256


def bwd256_order(route: str, batch: int, hq: int, hkv: int, sq: int, sk: int, *, causal: bool = True,
                 q_offset: int = 0, kv_len: Optional[int] = None, window: int = 0, sms: int = 132,
                 dims: Tuple[int, int] = (256, 256)) -> list:
    """The one-launch backward's work list (head_dim 256, and the
    tensor-core route's (192, 128): ``dims``), as its ``dkdv_dq`` kernel
    walks it: for each of ``min(items, sms)`` persistent blocks, its items
    in order. The items (:func:`bwd256_items`) go heaviest first
    (:func:`bwd256_weight` at ``dims``; ties by kind, batch, head, tile), each to the
    block with the least work so far (the lowest index among equals), so
    every block walks its own items heaviest first and no block ends more
    than one item's work after the mean."""
    import heapq

    items = bwd256_items(route, batch, hq, hkv, sq, sk, causal=causal, q_offset=q_offset, kv_len=kv_len,
                         window=window)
    items.sort(key=lambda it: (-bwd256_weight(it, dims), it[:4]))
    grid = min(len(items), sms)
    heap = [(0, i) for i in range(grid)]
    blocks = [[] for _ in range(grid)]
    for it in items:
        load, i = heapq.heappop(heap)
        blocks[i].append(it)
        heapq.heappush(heap, (load + bwd256_weight(it, dims), i))
    return blocks


#: the head_dim-256 work lists on the device, by device and call shape
_BWD256_WORK: dict = {}


def _bwd256_work(route: str, device: torch.device, *shape, **kw) -> Tuple[torch.Tensor, int]:
    """:func:`bwd256_order` as the kernel reads it, int32 on ``device``:
    the blocks' first positions (``grid + 1`` offsets), then each item's
    (kind, batch, head, tile); and the grid. Made once a shape and device,
    so a training step copies nothing to the device after its first
    call."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    key = (route, str(device), shape, tuple(sorted(kw.items())), sms)
    got = _BWD256_WORK.get(key)
    if got is None:
        blocks = bwd256_order(route, *shape, sms=sms, **kw)
        offsets = [0]
        for blk in blocks:
            offsets.append(offsets[-1] + len(blk))
        flat = offsets + [x for blk in blocks for it in blk for x in it[:4]]
        if len(_BWD256_WORK) >= 256:
            _BWD256_WORK.clear()
        got = _BWD256_WORK[key] = (torch.tensor(flat, dtype=torch.int32, device=device), len(blocks))
    return got


def live_end(sq: int, causal: bool, q_offset: int, kv_len: int) -> int:
    """One past the last key any query row may see."""
    return min(kv_len, int(q_offset) + sq) if causal else kv_len


def live_start(q_offset: int, window: int) -> int:
    """The first key any query row may see: the first row's window start
    (0 without a window)."""
    return max(0, int(q_offset) - int(window) + 1) if int(window) > 0 else 0


def split_plan(kv_end: int, batch_kv_heads: int, kv_start: int = 0) -> Tuple[int, int]:
    """The decode route's ``(keys_per_split, nsplit)``: ``[kv_start,
    kv_end)`` in splits of whole 64-key tiles, one block a (batch x KV
    head, split), as many as fit ``MAX_SPLIT_BLOCKS`` blocks and
    ``MAX_SPLITS`` splits; the last split may be short, none is empty."""
    tiles = -(-(kv_end - kv_start) // TILE_KEYS)
    per = min(tiles, max(-(-tiles * batch_kv_heads // MAX_SPLIT_BLOCKS), -(-tiles // MAX_SPLITS)))
    return per * TILE_KEYS, -(-tiles // per)


def split_kv_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
    keys_per_split: Optional[int] = None,
) -> torch.Tensor:
    """The decode kernel's algorithm in plain PyTorch, f32: per split of
    the live keys ``[live_start, live_end)`` a partial ``(m, l, acc)`` over
    -1e30-masked scores, then the log-sum-exp merge ``sum exp(m_i - M)
    acc_i / max(sum exp(m_i - M) l_i, 1e-30)``. Splits follow
    :func:`split_plan` unless ``keys_per_split`` is given."""
    kv_len = _check(q, k, v, softcap, q_offset, kv_len, window)
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    start, end = live_start(q_offset, window), live_end(sq, causal, q_offset, kv_len)
    if keys_per_split is None:
        keys_per_split, _ = split_plan(end, b * hkv, start)
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    ms, ls, accs = [], [], []
    for k0 in range(start, end, keys_per_split):
        k1 = min(k0 + keys_per_split, end)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k[:, :, k0:k1].float()) * (1.0 / math.sqrt(d))
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(~_mask(sq, torch.arange(k0, k1, device=q.device), causal, q_offset, kv_len, window),
                          NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, v[:, :, k0:k1].float()))
    m_all = torch.stack(ms)
    w = torch.exp(m_all - m_all.amax(dim=0))
    den = (w * torch.stack(ls)).sum(dim=0).clamp_min(1e-30)
    out = (w * torch.stack(accs)).sum(dim=0) / den
    return out.reshape(b, hq, sq, v.shape[3]).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
    with_lse: bool = False,
):
    """Attention of q ``[B, Hq, Sq, D]`` over k ``[B, Hkv, Sk, D]`` and v
    ``[B, Hkv, Sk, Dv]`` (see the module docstring); asynchronous on CUDA.
    Differentiable: when autograd wants a gradient the call goes through
    :class:`FlashAttention`. With ``with_lse`` it returns
    :func:`flash_attention_lse`'s ``(out, lse)`` (no gradient). A DTensor
    is refused: on a mesh the attention runs on each rank's local block
    (``repro_torch.models.blocks._attend``)."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and any(isinstance(t, dtensor.DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes plain tensors, got a DTensor: on a DeviceMesh hand it each "
                            "rank's local block (models.blocks attends through _attend)")
    kw = dict(causal=causal, softcap=softcap, q_offset=q_offset, kv_len=kv_len, window=window)
    if with_lse:
        return flash_attention_lse(q, k, v, **kw)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        kv_len = _check(q, k, v, softcap, q_offset, kv_len, window)
        _check_backward(q, v)
        return FlashAttention.apply(q, k, v, bool(causal), float(softcap), int(q_offset), kv_len, int(window))
    if q.device.type == "cpu":
        return attention_plain(q, k, v, **kw)
    return launch_route(_route(q, k, v=v), q, k, v, **kw)


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: :func:`flash_attention`'s output and each query
    row's log-sum-exp of its masked scores, f32 ``[B, Hq, Sq]`` (what
    :func:`attention_lse_plain` computes), for a caller that merges the
    outputs of calls over disjoint key blocks (:func:`merge_attention`;
    the hybrid's ring cache sharded along its slots). On the card the
    route :func:`flash_attention` takes (a decode step's is ``decode``,
    whose output is the same with the lse as without it); on the CPU the
    plain versions. No gradient: a serving step's call. A DTensor is
    refused, as by :func:`flash_attention`."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and any(isinstance(t, dtensor.DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention_lse takes plain tensors, got a DTensor: hand it each rank's local block")
    kw = dict(causal=causal, softcap=softcap, q_offset=q_offset, kv_len=kv_len, window=window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, **kw), attention_lse_plain(q, k, **kw)
    return launch_route(_route(q, k, v=v), q, k, v, with_lse=True, **kw)


def merge_attention(outs: torch.Tensor, lses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention over the union of ``n`` disjoint key blocks from each
    block's ``(out, lse)``, stacked: ``outs [n, B, Hq, Sq, Dv]``, ``lses
    [n, B, Hq, Sq]`` f32. In f32, ``M = max_i lse_i``, ``w_i = exp(lse_i -
    M)``, ``out = sum_i w_i out_i / sum_i w_i`` in ``outs``' dtype and
    ``lse = M + log(sum_i w_i)``, summed in block order. A block with no
    key of a row gives ``lse = -inf`` and ``out = 0`` there, and drops out
    exactly; a row no block has a key of is empty in the result too (``out
    = 0``, ``lse = -inf``), so that merges over parts of the blocks (one
    mesh dimension at a time) compose. One block is returned as it is, bit
    for bit. Plain PyTorch, the same on the CPU and the card."""
    if outs.shape[0] == 1:
        return outs[0], lses[0]
    m = lses.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # an empty row: every w_i 0, not NaN
    w = torch.exp(lses - m)
    den = w.sum(dim=0)
    out = (w[..., None] * outs.float()).sum(dim=0) / torch.where(den > 0, den, torch.ones_like(den))[..., None]
    return out.to(outs.dtype), m + torch.log(den)


def launch_route(
    route: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
    with_lse: bool = False,
):
    """Launch ``route``'s kernel on CUDA tensors, or raise where it does
    not take the call. :func:`flash_attention` picks the route; naming one
    here is for measurements that hold two routes side by side. With
    ``with_lse`` (every route) it returns ``(out, lse)``, the rows'
    log-sum-exp f32 ``[B, Hq, Sq]`` beside the output, which is the same
    output as without it."""
    kv_len = _check(q, k, v, softcap, q_offset, kv_len, window)
    b, hq, sq, d = q.shape
    hkv, vd = k.shape[1], v.shape[3]
    g = hq // hkv
    if route not in ROUTES:
        raise ValueError(f"flash_attention: unknown route {route!r}")
    if route == "tensor_core":
        if (d, vd) not in TC_DIM_PAIRS:
            raise ValueError(f"flash_attention: the tensor_core route takes (q/k, v) head_dim in {TC_DIM_PAIRS}, "
                             f"got head_dim ({d}, {vd}) of q {tuple(q.shape)}, v {tuple(v.shape)}")
    elif vd != d and not (route == "f32" and (d, vd) in CC_DIM_PAIRS):
        raise ValueError(f"flash_attention: the {route} route takes v's head_dim equal to q/k's (f32: also (q/k, "
                         f"v) in {CC_DIM_PAIRS}), got head_dim ({d}, {vd}) of q {tuple(q.shape)}, v {tuple(v.shape)}")
    elif vd == d:
        dims = HEAD_DIMS if route == "decode" else F32_HEAD_DIMS
        if d not in dims:
            raise ValueError(f"flash_attention: the {route} route takes head_dim in {dims}, got head_dim {d}")
    if route == "tensor_core" and q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: the tensor_core route takes bfloat16, got {q.dtype}")
    if route == "decode" and q.dtype not in DECODE_DTYPES:
        raise TypeError(f"flash_attention: the decode route takes float32 or bfloat16, got {q.dtype}")
    if route == "decode" and sq * g > DECODE_ROWS:
        raise ValueError(f"flash_attention: the decode route takes Sq * Hq/Hkv <= {DECODE_ROWS}, got {sq * g}")
    if route == "f32" and g > MAX_GROUP:
        raise ValueError(f"flash_attention: the f32 route takes Hq/Hkv <= {MAX_GROUP}, got {g}")
    if q.device.type != "cuda":
        raise TypeError(f"flash_attention: unsupported device {q.device}")
    out = torch.empty((b, sq, hq, vd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lse_ptr = lse.data_ptr() if with_lse else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(strides))
    flags = (int(bool(causal)), float(softcap), int(q_offset), kv_len, max(int(window), 0))
    lib = build.library()
    stream = build.stream_ptr(q.device)
    if route == "decode":
        keys, nsplit = split_plan(live_end(sq, causal, q_offset, kv_len), b * hkv, live_start(q_offset, window))
        part = torch.empty(b * hkv * nsplit * sq * g * (d + 2), dtype=torch.float32, device=q.device)
        counters = _split_counters(q.device, b * hkv)
    LAUNCHES.add()
    ROUTE_LAUNCHES[route].add()
    if route == "decode":
        name = "th_flash_decode"
        err = lib.th_flash_decode(*args, _CODES[q.dtype], b, hq, hkv, sq, d, *flags, keys, nsplit,
                                  part.data_ptr(), counters.data_ptr(), lse_ptr, stream)
    elif route == "tensor_core":
        name = "th_flash_attention_tc"
        err = lib.th_flash_attention_tc(*args, b, hq, hkv, sq, d, vd, *flags, lse_ptr, stream)
    else:
        name = "th_flash_attention"
        err = lib.th_flash_attention(*args, _CODES[q.dtype], b, hq, hkv, sq, d, vd, *flags, lse_ptr, stream)
    build.check(name, err)
    return (out, lse) if with_lse else out


def _bwd_takes(route: str, dtype: torch.dtype, d: int, dv: int) -> bool:
    """Whether ``route``'s backward kernels take (q/k, v) head_dims ``(d,
    dv)`` in ``dtype``: ``tensor_core`` bf16 at ``TC_DIM_PAIRS``,
    ``cuda_core`` head_dim ``BWD_HEAD_DIMS`` with Dv = D and the pairs of
    ``CC_DIM_PAIRS``, in f32, bf16 and f16."""
    if route == "tensor_core":
        return dtype == torch.bfloat16 and (d, dv) in TC_DIM_PAIRS
    return (d == dv and d in BWD_HEAD_DIMS) or (d, dv) in CC_DIM_PAIRS


def _check_backward(q: torch.Tensor, v: Optional[torch.Tensor] = None) -> None:
    """Raise where no backward kernel takes the call: on CUDA, a (q/k, v)
    head_dim pair (v's is q's unless ``v`` is given) that neither route
    takes in q's dtype, named with what it waits for (the plain version on
    the CPU takes any)."""
    d = q.shape[-1]
    dv = d if v is None else v.shape[-1]
    if q.device.type == "cpu" or any(_bwd_takes(r, q.dtype, d, dv) for r in BWD_KERNELS):
        return
    if (d, dv) in TC_DIM_PAIRS:
        why = f"({d}, {dv}) runs on the tensor cores in bfloat16 only; a CUDA-core backward at it is not written"
    elif d == dv:
        why = f"no kernel has head_dim {d}" + ("; q/k 192 goes with a v of 128 only" if d == 192 else "")
    else:
        why = "no other Dv != D pair has a kernel"
    raise NotImplementedError(
        f"flash_attention: the backward kernels take bfloat16 (q/k, v) head_dims {TC_DIM_PAIRS} (tensor_core), "
        f"head_dim {BWD_HEAD_DIMS} and {CC_DIM_PAIRS} (cuda_core), got ({d}, {dv}) in {q.dtype} ({why})")


def attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of the attention: the backward kernels on CUDA
    tensors (:func:`launch_backward`), :func:`attention_backward_plain`
    on CPU tensors."""
    kw = dict(causal=causal, softcap=softcap, q_offset=q_offset, kv_len=kv_len, window=window)
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, out, lse, dout, **kw)
    return launch_backward(q, k, v, out, lse, dout, **kw)


def launch_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch a backward route's kernels on CUDA tensors, or raise where
    the route does not take the call: ``route`` defaults to
    :func:`_bwd_route`'s choice; naming one is for measurements that hold
    the two side by side. ``tensor_core`` (bf16, (q/k, v) head_dims
    ``TC_DIM_PAIRS``): the kernels of ``csrc/flash_attention_bwd_tc.cu``;
    ``cuda_core`` (f32, bf16 or f16, head_dim 16/32/64/80/128/256 and (24,
    16)): the kernels of ``csrc/flash_attention_bwd.cu`` (:func:`bwd_kernels`
    names them). Both take a window and strided
    q/k/v/out/dout; ``lse`` is the forward's (:func:`launch_route`
    ``with_lse``). The gradients are laid out ``[B, S, H, D]`` under their
    ``[B, H, S, D]`` views, as the forward's output."""
    kv_len = _check(q, k, v, softcap, q_offset, kv_len, window)
    b, hq, sq, d = q.shape
    hkv, sk, vd = k.shape[1], k.shape[2], v.shape[3]
    route = _bwd_route(q, v) if route is None else route
    if route not in BWD_KERNELS:
        raise ValueError(f"flash_attention backward: unknown route {route!r}")
    _check_backward(q, v)
    if not _bwd_takes(route, q.dtype, d, vd):
        takes = (f"bfloat16 at (q/k, v) head_dim {TC_DIM_PAIRS}" if route == "tensor_core" else
                 f"head_dim {BWD_HEAD_DIMS} with v's equal, and (q/k, v) {CC_DIM_PAIRS}")
        raise ValueError(f"flash_attention backward: the {route} route takes {takes}, got {q.dtype} at "
                         f"({d}, {vd})")
    if q.device.type != "cuda":
        raise TypeError(f"flash_attention backward: unsupported device {q.device}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_attention backward: Hq/Hkv <= {MAX_GROUP}, got {hq // hkv}")
    o_shape = (b, hq, sq, vd)
    if out.shape != o_shape or dout.shape != o_shape or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must be {o_shape} {q.dtype}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: lse must be float32 {(b, hq, sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not (q.device == out.device == lse.device == dout.device):
        raise ValueError("flash_attention backward: q, out, lse and dout must be on one device")
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype, device=k.device).transpose(1, 2)
    dv = torch.empty((b, sk, hkv, vd), dtype=v.dtype, device=v.device).transpose(1, 2)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    tensors = (q, k, v, out, dout, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(st for t in tensors for st in t.stride()[:3]))
    tail = (b, hq, hkv, sq, sk, d, vd, int(bool(causal)), float(softcap), int(q_offset), kv_len, max(int(window), 0))
    ptrs = tuple(t.data_ptr() for t in tensors)
    lib = build.library()
    stream = build.stream_ptr(q.device)
    if route == "tensor_core":
        # each 64-row query tile's lse log2 e and D_i, written by the pre kernel
        stats = torch.empty(b * hq * -(-sq // TC_BWD_TILE) * 2 * TC_BWD_TILE, dtype=torch.float32, device=q.device)
        args = (*ptrs, lse.data_ptr(), stats.data_ptr(), ctypes.addressof(strides), *tail, stream)
    else:
        # each packed sub-tile's lse and D_i, written by the pre kernel, in
        # whole 128-row tiles of the dq kernel
        _, nsub = packed_rows(sq, hq // hkv)
        stats = torch.empty(b * hkv * (nsub + nsub % 2) * 2 * SUB_ROWS, dtype=torch.float32, device=q.device)
        args = (*ptrs, lse.data_ptr(), stats.data_ptr(), ctypes.addressof(strides), _CODES[q.dtype], *tail, stream)
    # every launch's arguments first, so the card does not wait on the host
    # between them
    calls = []
    for kernel in bwd_kernels(d, vd):
        call = args
        if kernel == "dkdv_dq":
            work, grid = _bwd256_work(route, q.device, b, hq, hkv, sq, sk, causal=bool(causal),
                                      q_offset=int(q_offset), kv_len=kv_len, window=max(int(window), 0),
                                      dims=(d, vd))
            call = (*args[:-1], work.data_ptr(), grid, stream)
        name = f"th_flash_bwd_{'tc_' if route == 'tensor_core' else ''}{kernel}"
        calls.append((kernel, name, getattr(lib, name), call))
    for kernel, name, fn, call in calls:
        BWD_LAUNCHES[f"{route}/{kernel}"].add()
        build.check(name, fn(*call))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward on the route
    ``_route(q, k, grad=True)`` picks, saving the rows' log-sum-exp, and
    the backward's kernels (the plain versions of both on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, softcap: float, q_offset: int, kv_len: int, window: int = 0):
        kw = dict(causal=causal, softcap=softcap, q_offset=q_offset, kv_len=kv_len, window=window)
        if q.device.type == "cpu":
            out = attention_plain(q, k, v, **kw)
            lse = attention_lse_plain(q, k, **kw)
        else:
            out, lse = launch_route(_route(q, k, grad=True, v=v), q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


_COUNTERS: dict = {}


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """The decode kernel's per-(batch, KV head) split counters on
    ``device``: zeros, kept between calls (the block that merges a row's
    splits resets its counter), so a step launches one kernel and no
    memset. Calls on one device share them; they run in stream order on
    the serving path."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


# ---------------------------------------------------------------------------
# The operator: the same routes as a torch.library op, with its fake, its
# autograd and its work
# ---------------------------------------------------------------------------


def live_pairs(sq: int, kv_len: int, causal: bool = True, q_offset: int = 0, window: int = 0) -> int:
    """The (query row, key) pairs of one query head that the masks leave
    live: key j is live for row i when ``j < kv_len``, (causal) ``j <=
    q_offset + i`` and (window) ``j > q_offset + i - window``, the mask of
    :func:`_mask`. Summed in closed form over the runs of rows on which the
    live count is one linear function of the row."""
    q_offset, kv_len, window = int(q_offset), int(kv_len), int(window)

    def hi(p: int) -> int:
        return min(kv_len, p + 1) if causal else kv_len

    def lo(p: int) -> int:
        return max(0, p - window + 1) if window > 0 else 0

    # rows where hi or lo changes slope: between two of them the live count
    # is f0 + slope * t at row a + t, slope -1, 0 or 1; summed where positive
    cuts = {kv_len - 1, window - 1}
    edges = sorted({q_offset, q_offset + sq} | {p for p in cuts if q_offset < p < q_offset + sq})
    total = 0
    for a, b in zip(edges, edges[1:]):
        n = b - a
        f0 = hi(a) - lo(a)
        slope = (hi(b - 1) - lo(b - 1) - f0) // (n - 1) if n > 1 else 0
        if slope == 0:
            total += n * max(f0, 0)
        elif slope > 0:
            t0 = max(0, 1 - f0)  # the first row with a live key
            m = n - t0
            if m > 0:
                total += m * (f0 + t0) + m * (m - 1) // 2
        else:
            m = min(n, max(0, f0))  # the rows before the count reaches 0
            total += m * f0 - m * (m - 1) // 2
    return total


def forward_flops(b: int, hq: int, sq: int, d: int, dv: int, *, kv_len: int, causal: bool = True, q_offset: int = 0,
                  window: int = 0) -> int:
    """The products a forward route computes: S (``2 D``) and P V (``2
    Dv``) a live pair, each query head, each batch row."""
    return 2 * (d + dv) * b * hq * live_pairs(sq, kv_len, causal, q_offset, window)


def backward_flops(b: int, hq: int, sq: int, d: int, dv: int, *, kv_len: int, causal: bool = True, q_offset: int = 0,
                   window: int = 0) -> int:
    """The products either backward route computes a live pair: seven
    (``csrc/flash_attention_bwd_tc.cu`` and ``flash_attention_bwd.cu``,
    their headers: S and dP in the dK/dV kernel and again in the dQ
    kernel, or in the dK/dV and dQ items of the one-launch kernel, then
    dV, dK and dQ): S, dK and dQ of ``2 D`` each, twice S's, and dP, dV of
    ``2 Dv``, twice dP's: ``2 (4 D + 3 Dv)``."""
    return 2 * (4 * d + 3 * dv) * b * hq * live_pairs(sq, kv_len, causal, q_offset, window)


def _empty_like_out(q: torch.Tensor, b: int, s: int, h: int, d: int) -> torch.Tensor:
    """An output ``[B, H, S, D]`` as the call lays it out on ``q``'s
    device: on the card a view of a ``[B, S, H, D]`` tensor, the layout in
    which every route writes; on the CPU contiguous, as the plain versions
    return it."""
    if q.device.type == "cpu":
        return q.new_empty((b, h, s, d))
    return q.new_empty((b, s, h, d)).transpose(1, 2)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, softcap: float,
                        q_offset: int, kv_len: int, window: int, with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    kw = dict(causal=causal, softcap=softcap, q_offset=q_offset, kv_len=kv_len, window=window)
    none = q.new_empty((0,), dtype=torch.float32)
    if q.device.type == "cpu":
        out = attention_plain(q, k, v, **kw)
        return out, (attention_lse_plain(q, k, **kw) if with_lse else none)
    if with_lse:
        return launch_route(_route(q, k, grad=True, v=v), q, k, v, with_lse=True, **kw)
    return launch_route(_route(q, k, v=v), q, k, v, **kw), none


@_flash_attention_op.register_fake
def _(q, k, v, causal, softcap, q_offset, kv_len, window, with_lse):
    b, hq, sq, _ = q.shape
    lse = q.new_empty((b, hq, sq) if with_lse else (0,), dtype=torch.float32)
    return _empty_like_out(q, b, sq, hq, v.shape[3]), lse


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=())
def _flash_attention_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, dout: torch.Tensor, causal: bool, softcap: float, q_offset: int,
                                 kv_len: int, window: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return attention_backward(q, k, v, out, lse, dout, causal=causal, softcap=softcap, q_offset=q_offset,
                              kv_len=kv_len, window=window)


@_flash_attention_backward_op.register_fake
def _(q, k, v, out, lse, dout, causal, softcap, q_offset, kv_len, window):
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    return _empty_like_out(q, b, sq, hq, d), _empty_like_out(k, b, sk, hkv, d), _empty_like_out(v, b, sk, hkv, dv)


def _op_setup(ctx, inputs, output):
    q, k, v, causal, softcap, q_offset, kv_len, window, _ = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.flags = (causal, softcap, q_offset, kv_len, window)


def _op_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attention_backward(q, k, v, out, lse, dout, *ctx.flags)
    return dq, dk, dv, None, None, None, None, None, None


_flash_attention_op.register_autograd(_op_backward, setup_context=_op_setup)


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def _flash_attention_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, softcap: float,
                            q_offset: int, kv_len: int, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_lse(q, k, v, causal=causal, softcap=softcap, q_offset=q_offset, kv_len=kv_len,
                               window=window)


@_flash_attention_lse_op.register_fake
def _(q, k, v, causal, softcap, q_offset, kv_len, window):
    b, hq, sq, _ = q.shape
    return _empty_like_out(q, b, sq, hq, v.shape[3]), q.new_empty((b, hq, sq), dtype=torch.float32)


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _(q, k, v, causal, softcap, q_offset, kv_len, window, with_lse, *args, out_shape=None, **kw) -> int:
        b, hq, sq, d = q
        return forward_flops(b, hq, sq, d, v[3], kv_len=kv_len, causal=causal, q_offset=q_offset, window=window)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_lse)
    def _(q, k, v, causal, softcap, q_offset, kv_len, window, *args, out_shape=None, **kw) -> int:
        b, hq, sq, d = q
        return forward_flops(b, hq, sq, d, v[3], kv_len=kv_len, causal=causal, q_offset=q_offset, window=window)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
    def _(q, k, v, out, lse, dout, causal, softcap, q_offset, kv_len, window, *args, out_shape=None, **kw) -> int:
        b, hq, sq, d = q
        return backward_flops(b, hq, sq, d, v[3], kv_len=kv_len, causal=causal, q_offset=q_offset, window=window)


_register_flop_formulas()


def flash_attention_lse_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_lse` through the operator
    ``torch.ops.repro_torch.flash_attention_lse``: the same bits, with a
    fake and the forward's FLOP formula for a trace (as
    :func:`flash_attention_op`)."""
    kv_len = _check(q, k, v, softcap, q_offset, kv_len, window)
    return torch.ops.repro_torch.flash_attention_lse(q, k, v, bool(causal), float(softcap), int(q_offset), kv_len,
                                                     int(window))


def flash_attention_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: int = 0,
    with_lse: bool = False,
):
    """:func:`flash_attention` through the operator
    ``torch.ops.repro_torch.flash_attention``: the same route and kernels
    (the plain versions on the CPU), the same bits, and, where autograd
    wants a gradient, the same forward with the lse and the backward
    ``torch.ops.repro_torch.flash_attention_backward``; with ``with_lse``
    :func:`flash_attention_lse_op`'s ``(out, lse)``. What the op adds is
    for tracing: a fake (shapes, dtypes and the layout of the device's
    outputs, no data), so a trace of fake tensors runs no attention, and a
    FLOP formula
    (``torch.utils.flop_counter``: :func:`forward_flops`,
    :func:`backward_flops`) that counts the live pairs the kernels compute,
    where a trace would otherwise see whatever the call decomposes into."""
    if with_lse:
        return flash_attention_lse_op(q, k, v, causal=causal, softcap=softcap, q_offset=q_offset, kv_len=kv_len,
                                      window=window)
    kv_len = _check(q, k, v, softcap, q_offset, kv_len, window)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if grad:
        _check_backward(q, v)
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), float(softcap), int(q_offset), kv_len,
                                                 int(window), grad)[0]
