"""The absorbed multi-head latent attention of a decode step (deepseek-v3).

``mla_decode(q_abs, q_rope, ckv, krope, kv_len=, scale=)`` takes the
queries folded into the latent space, ``q_abs [B, H, 1, R]``, their rope
part ``q_rope [B, H, 1, rd]``, and a layer's latent cache ``ckv [B, Smax,
R]`` and rope keys ``krope [B, Smax, rd]``, and returns the latent output
``out_lat [B, H, 1, R]`` in f32:

    s       = ((q_abs . ckv_t) + (q_rope . krope_t)) * scale     in f32
    s       = -1e30 where slot t >= kv_len                         (no causal term)
    out_lat = softmax(s) . ckv                                     in f32

what the JAX package's absorbed decode (``repro/models/blocks.py``,
``mla_apply`` with a cache) computes with f32 einsums. The H query heads
share one latent "KV head" of width ``R + rd``; the scale is the caller's,
``1/sqrt(qk_nope + qk_rope)`` (1/sqrt(192) for deepseek-v3, not
1/sqrt(R + rd)).

On a CUDA tensor it launches the hand-written split-KV kernel
(``csrc/mla_decode.cu``: bf16 in, ``R = 512``, ``rd = 64``, one query a
head) or raises; the JAX package has no Pallas kernel for this (XLA
computes its einsums), so the kernel replaces those einsums. Both of its
products run on the tensor cores: S over ``[q_abs | q_rope] . [ckv |
krope]`` (bf16 operands, exact products in f32), and P.V with each f32
weight as two bf16 operands, ``P_hi + P_lo``, so the output stays within
the f32 gate. The slots ``[0, kv_len)`` are cut into splits of whole
32-key tiles (:func:`split_plan`), one block a (split, 64 heads, batch),
each tile read once by TMA with the cache's slot extent at ``kv_len``
(the dead slots arrive as zeros); a second small kernel merges the
splits' partial softmax states of each (batch, head) row in split order
(what :func:`mla_decode_split_plain` computes in plain PyTorch), so a
rerun gives the same bits. One launch of the wrapper is the split kernel
and, with more than one split, the merge after it on the same stream.

On a CPU tensor it runs :func:`mla_decode_plain`, the reference's einsums
in f32, and launches nothing. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
LATENT, ROPE = 512, 64  # the kernel's widths: deepseek-v3's kv_lora_rank and qk_rope_head_dim
TILE_KEYS = 32  # keys a tile of the kernel, and the unit of a split
HEADS_PER_BLOCK = 64
MAX_BLOCKS = 132  # one wave of the kernel (one block an SM)
MAX_SPLITS = 64

#: launches of the kernel (bumped only where it is launched)
LAUNCHES = build.LaunchCount()


def _check(q_abs, q_rope, ckv, krope, kv_len: int) -> Tuple[int, int, int, int, int]:
    """Validate the call; return ``(B, H, R, rd, Smax)``."""
    if q_abs.dim() != 4 or q_rope.dim() != 4 or ckv.dim() != 3 or krope.dim() != 3:
        raise ValueError(f"mla_decode: want q_abs [B,H,S,R], q_rope [B,H,S,rd], ckv [B,Smax,R], krope [B,Smax,rd], "
                         f"got {tuple(q_abs.shape)}, {tuple(q_rope.shape)}, {tuple(ckv.shape)}, {tuple(krope.shape)}")
    b, h, s, r = q_abs.shape
    rd = q_rope.shape[3]
    smax = ckv.shape[1]
    if q_rope.shape[:3] != (b, h, s) or ckv.shape != (b, smax, r) or krope.shape != (b, smax, rd):
        raise ValueError(f"mla_decode: shapes disagree: q_abs {tuple(q_abs.shape)}, q_rope {tuple(q_rope.shape)}, "
                         f"ckv {tuple(ckv.shape)}, krope {tuple(krope.shape)}")
    if not q_abs.dtype == q_rope.dtype == ckv.dtype == krope.dtype:
        raise TypeError(f"mla_decode: want one dtype, got {q_abs.dtype}/{q_rope.dtype}/{ckv.dtype}/{krope.dtype}")
    if not (q_abs.device == q_rope.device == ckv.device == krope.device):
        raise ValueError("mla_decode: q_abs, q_rope, ckv and krope must be on one device")
    if not 1 <= int(kv_len) <= smax:
        raise ValueError(f"mla_decode: kv_len {kv_len} outside [1, {smax}]")
    return b, h, r, rd, smax


def mla_decode_plain(
    q_abs: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor, krope: torch.Tensor, *, kv_len: int, scale: float
) -> torch.Tensor:
    """The reference's einsums in f32 on any device: the scores of the
    first ``kv_len`` slots (a masked slot's -1e30 gives it weight exactly
    0 in the reference, so the slots past ``kv_len`` are not read, and
    whatever they hold stays out), their softmax and its product with the
    latent rows. Any S (queries a head) and any widths."""
    _check(q_abs, q_rope, ckv, krope, kv_len)
    c, kr = ckv[:, :kv_len].float(), krope[:, :kv_len].float()
    s = (torch.einsum("bhsr,btr->bhst", q_abs.float(), c)
         + torch.einsum("bhsd,btd->bhst", q_rope.float(), kr)) * scale
    return torch.einsum("bhst,btr->bhsr", torch.softmax(s, dim=-1), c)


def split_plan(kv_len: int, batch: int, heads: int) -> Tuple[int, int]:
    """The kernel's ``(keys_per_split, nsplit)``: ``[0, kv_len)`` in splits
    of whole 32-key tiles, as many as fit ``MAX_BLOCKS`` blocks of
    (split, 64 heads, batch) and ``MAX_SPLITS`` splits; the last split may
    be short, none is empty. One wave of blocks, one an SM: at the served
    step (4 x 128 heads, 528 slots) 9 splits of two tiles, which ran
    faster than 17 of one tile (136 blocks: a second wave and twice the
    f32 partials)."""
    tiles = -(-kv_len // TILE_KEYS)
    groups = batch * -(-heads // HEADS_PER_BLOCK)
    per = min(tiles, max(-(-tiles * groups // MAX_BLOCKS), -(-tiles // MAX_SPLITS)))
    return per * TILE_KEYS, -(-tiles // per)


def mla_decode_split_plain(
    q_abs: torch.Tensor,
    q_rope: torch.Tensor,
    ckv: torch.Tensor,
    krope: torch.Tensor,
    *,
    kv_len: int,
    scale: float,
    keys_per_split: int = 0,
    p_lo: bool = True,
) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch, f32: per split (of
    :func:`split_plan` unless ``keys_per_split`` is given) an online
    softmax over 32-key tiles, the scores over ``[q_abs | q_rope] . [ckv |
    krope]`` summed in two halves of their columns (one a warpgroup of the
    kernel) and then added, -1e30 past the
    split's end (where the kernel's tile holds zeros); the weights as
    ``P_hi = bf16(p)`` and ``P_lo = bf16(p - P_hi)``, each against the
    latent rows, added to the f32 sum in that order, the row sum ``l``
    from the f32 ``p``; then the log-sum-exp merge of the splits in order,
    ``sum exp(m_i - M) acc_i / max(sum exp(m_i - M) l_i, 1e-30)``.
    ``p_lo=False`` drops ``P_lo`` (one bf16 operand a weight), which
    misses the f32 gate."""
    b, h, _, _, _ = _check(q_abs, q_rope, ckv, krope, kv_len)
    if not keys_per_split:
        keys_per_split, _ = split_plan(kv_len, b, h)
    q = torch.cat([q_abs, q_rope], dim=-1).float()
    r = ckv.shape[2]
    half = (r + krope.shape[2]) // 2
    ms, ls, accs = [], [], []
    for k0 in range(0, kv_len, keys_per_split):
        k1 = min(k0 + keys_per_split, kv_len)
        m = torch.full((*q.shape[:3], 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((*q.shape[:3], r), dtype=torch.float32, device=q.device)
        for t0 in range(k0, k1, TILE_KEYS):
            live = torch.arange(t0, min(t0 + TILE_KEYS, ckv.shape[1]), device=q.device) < k1
            kv = torch.cat([ckv[:, t0 : t0 + TILE_KEYS], krope[:, t0 : t0 + TILE_KEYS]], dim=-1).float()
            kv = kv.masked_fill(~live[:, None], 0.0)
            s = (torch.einsum("bhsw,btw->bhst", q[..., :half], kv[..., :half])
                 + torch.einsum("bhsw,btw->bhst", q[..., half:], kv[..., half:]))
            s = (s * scale).masked_fill(~live, NEG_INF)
            mc = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - mc)
            p = torch.exp(s - mc)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            p_hi = p.bfloat16().float()
            acc = acc * alpha + torch.einsum("bhst,btr->bhsr", p_hi, kv[..., :r])
            if p_lo:
                acc = acc + torch.einsum("bhst,btr->bhsr", (p - p_hi).bfloat16().float(), kv[..., :r])
            m = mc
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m_all = torch.stack(ms)
    w = torch.exp(m_all - m_all.amax(dim=0))
    den = (w * torch.stack(ls)).sum(dim=0).clamp_min(1e-30)
    return (w * torch.stack(accs)).sum(dim=0) / den


def mla_decode(
    q_abs: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor, krope: torch.Tensor, *, kv_len: int, scale: float
) -> torch.Tensor:
    """``out_lat [B, H, 1, R]`` f32 of the absorbed decode (see the module
    docstring): the kernel on CUDA tensors, asynchronous;
    :func:`mla_decode_plain` on CPU tensors."""
    if q_abs.device.type == "cpu":
        return mla_decode_plain(q_abs, q_rope, ckv, krope, kv_len=kv_len, scale=scale)
    return launch(q_abs, q_rope, ckv, krope, kv_len=kv_len, scale=scale)


def _slot_strides(t: torch.Tensor, name: str) -> Tuple[int, int]:
    """A cache's batch and slot strides, where the kernel's tensor maps
    (TMA: a 16-byte aligned base, strides in whole 16 bytes) can read its
    rows in place; else raise (a copy of the whole cache a
    step is no place to fall into quietly)."""
    st = t.stride()
    if st[2] != 1 or t.data_ptr() % 16 or any(x % 8 for x in st[:2]):
        raise ValueError(f"mla_decode: {name} rows must be contiguous and 16-byte aligned, got strides {st}")
    return st[0], st[1]


def launch(
    q_abs: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor, krope: torch.Tensor, *, kv_len: int, scale: float
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors, or raise where it does not take
    the call: bf16, one query a head, ``R = 512``, ``rd = 64``."""
    b, h, r, rd, _ = _check(q_abs, q_rope, ckv, krope, kv_len)
    if q_abs.dtype != torch.bfloat16:
        raise TypeError(f"mla_decode: the kernel takes bfloat16, got {q_abs.dtype}")
    if q_abs.shape[2] != 1:
        raise ValueError(f"mla_decode: the kernel takes one query a head, got {q_abs.shape[2]}")
    if (r, rd) != (LATENT, ROPE):
        raise ValueError(f"mla_decode: the kernel takes (R, rd) = ({LATENT}, {ROPE}), got ({r}, {rd})")
    if q_abs.device.type != "cuda":
        raise TypeError(f"mla_decode: unsupported device {q_abs.device}")
    kv_len = int(kv_len)
    cb, cs = _slot_strides(ckv, "ckv")
    rb, rs = _slot_strides(krope, "krope")
    qa, qr = q_abs.contiguous(), q_rope.contiguous()
    out = torch.empty((b, h, 1, r), dtype=torch.float32, device=q_abs.device)
    keys, nsplit = split_plan(kv_len, b, h)
    part = torch.empty(b * h * nsplit * (r + 2) if nsplit > 1 else 1, dtype=torch.float32, device=q_abs.device)
    lib = build.library()
    LAUNCHES.add()
    err = lib.th_mla_decode(qa.data_ptr(), qr.data_ptr(), ckv.data_ptr(), krope.data_ptr(), out.data_ptr(), b, h,
                            cb, cs, rb, rs, kv_len, keys, nsplit, float(scale), part.data_ptr(),
                            build.stream_ptr(q_abs.device))
    build.check("th_mla_decode", err)
    return out



# ---------------------------------------------------------------------------
# The operator: the same call as a torch.library op, with its fake and its
# work
# ---------------------------------------------------------------------------


def decode_flops(b: int, h: int, s: int, r: int, rd: int, *, kv_len: int) -> int:
    """The products the kernel computes a (batch row, head, query, live
    slot): S over ``[q_abs | q_rope] . [ckv | krope]`` (``2 (R + rd)``) and
    P.V twice, ``P_hi`` and ``P_lo`` against the same latent rows (``2 x 2
    R``)."""
    return 2 * (r + rd + 2 * r) * b * h * s * int(kv_len)


@torch.library.custom_op("repro_torch::mla_decode", mutates_args=())
def _mla_decode_op(q_abs: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor, krope: torch.Tensor, kv_len: int,
                   scale: float) -> torch.Tensor:
    if q_abs.device.type == "cpu":  # the plain version, laid out as the kernel writes
        out = q_abs.new_empty(q_abs.shape, dtype=torch.float32)
        return out.copy_(mla_decode_plain(q_abs, q_rope, ckv, krope, kv_len=kv_len, scale=scale))
    return launch(q_abs, q_rope, ckv, krope, kv_len=kv_len, scale=scale)


@_mla_decode_op.register_fake
def _(q_abs, q_rope, ckv, krope, kv_len, scale):
    return q_abs.new_empty(q_abs.shape, dtype=torch.float32)


def _register_flop_formula() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.mla_decode)
    def _(q_abs, q_rope, ckv, krope, kv_len, scale, *args, out_shape=None, **kw) -> int:
        b, h, s, r = q_abs
        return decode_flops(b, h, s, r, q_rope[3], kv_len=kv_len)


_register_flop_formula()


def mla_decode_op(
    q_abs: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor, krope: torch.Tensor, *, kv_len: int, scale: float
) -> torch.Tensor:
    """:func:`mla_decode` through the operator
    ``torch.ops.repro_torch.mla_decode``: the same kernel (the plain
    version on the CPU) and the same bits, with a fake (shape and dtype, no
    data) and a FLOP formula (:func:`decode_flops`) for a trace."""
    _check(q_abs, q_rope, ckv, krope, kv_len)
    return torch.ops.repro_torch.mla_decode(q_abs, q_rope, ckv, krope, int(kv_len), float(scale))
