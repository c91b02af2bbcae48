"""Flash attention on the device: the attention of the decoder's prefill
and decode.

``flash_attention(q, k, v, causal=, softcap=, q_offset=, kv_len=)`` takes
q ``[B, Hq, Sq, D]`` and k, v ``[B, Hkv, Sk, D]`` (the JAX wrapper's
layout, ``repro/kernels/flash_attention/ops.py``) and returns
``[B, Hq, Sq, D]`` in q's dtype:

    s   = (q . k) / sqrt(D)               in f32
    s   = softcap * tanh(s / softcap)      when softcap > 0
    s   = -1e30 where key j >= kv_len, or (causal) j > q_offset + i
    out = softmax(s) @ v

with GQA (query head h reads KV head ``h // (Hq // Hkv)``, no copy of K or
V). ``q_offset`` places query row 0 in the sequence and ``kv_len`` is the
number of valid keys (default ``Sk``): a decode step passes the cache
length and a cache of ``max_len`` slots. With the defaults it computes what
the Pallas kernel ``flash_attention_bh``
(``repro/kernels/flash_attention/kernel.py``) computes.

On a CUDA tensor it launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises; on a CPU tensor it runs
:func:`attention_plain`, the plain PyTorch version (naive f32 softmax, as
the JAX package's ``ref.py:attention_ref`` and
``layers.py:reference_attention``) that the kernel is held against. Both
take f32 or bf16; the kernel takes head_dim 64, 128 or 256 and
``Hq / Hkv <= 64``, and the wrapper raises on a CUDA tensor outside
those.

The kernel's output lies in memory as ``[B, Sq, Hq, D]`` under the
``[B, Hq, Sq, D]`` view it returns, so merging the heads afterwards is a
view, not a copy.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: kernel dtype codes (csrc/flash_attention.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 64  # query heads packed into one 64-row tile

#: launches of the CUDA kernel (bumped only where it is launched)
LAUNCHES = build.LaunchCount()


def _check(q, k, v, softcap: float, q_offset: int, kv_len: Optional[int]) -> int:
    """Validate the call; return the effective ``kv_len``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: want q [B,Hq,Sq,D], k = v [B,Hkv,Sk,D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, _, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} must be a multiple of Hkv={hkv}")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: want float32 or bfloat16 throughout, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one device")
    kv_len = sk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [1, {sk}]")
    if int(q_offset) < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if softcap < 0:
        raise ValueError(f"flash_attention: softcap {softcap} < 0")
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
) -> torch.Tensor:
    """Plain PyTorch version on any device: the whole score matrix in f32,
    masked with -1e30, a softmax, and the product with v (GQA by grouping
    the query heads, without repeating K/V)."""
    kv_len = _check(q, k, v, softcap, q_offset, kv_len)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * (1.0 / math.sqrt(d))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(sk, device=q.device)
    mask = (kpos < kv_len)[None, :]
    if causal:
        qpos = int(q_offset) + torch.arange(sq, device=q.device)
        mask = mask & (kpos[None, :] <= qpos[:, None])
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel's 4-element vector loads can read its rows in
    place (unit stride in D, 4-element aligned rows), else a contiguous
    copy."""
    isz = t.element_size()
    ok = (
        t.stride(3) == 1
        and t.data_ptr() % (4 * isz) == 0
        and all(t.stride(i) % 4 == 0 or t.size(i) == 1 for i in range(3))
    )
    return t if ok else t.contiguous()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention of q ``[B, Hq, Sq, D]`` over k, v ``[B, Hkv, Sk, D]``
    (see the module docstring); asynchronous on CUDA."""
    kv_len = _check(q, k, v, softcap, q_offset, kv_len)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, softcap=softcap, q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise TypeError(f"flash_attention: unsupported device {q.device}")
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if d not in HEAD_DIMS or hq // hkv > MAX_GROUP:
        raise ValueError(
            f"flash_attention: the kernel takes head_dim in {HEAD_DIMS} and Hq/Hkv <= {MAX_GROUP}, "
            f"got head_dim {d}, Hq/Hkv {hq // hkv}"
        )
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    lib = build.library()
    LAUNCHES.add()
    err = lib.th_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
        _CODES[q.dtype], b, hq, hkv, sq, d, int(bool(causal)), float(softcap),
        int(q_offset), kv_len, build.stream_ptr(q.device),
    )
    build.check("th_flash_attention", err)
    return out
