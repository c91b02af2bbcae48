"""End-to-end transfer checksum on the device (paper 4.6).

``checksum_words(buf)`` returns ``(s1, s2)`` over the little-endian
uint32 words of a flat uint8 tensor (the last word zero-padded):

    s1 = sum(w_i)                      mod 2^32
    s2 = sum(((i & 0xFFFF) + 1) * w_i) mod 2^32

On a CUDA tensor it launches the hand-written kernel
(``csrc/checksum.cu``, which replaces the Pallas kernel
``repro/kernels/checksum/kernel.py:checksum_words``) or raises; on a CPU
tensor it runs :func:`checksum_words_plain`, the plain PyTorch version
the kernel is held against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_MASK32 = 0xFFFFFFFF
#: words per masked partial sum in the plain version: products reach
#: 2^48, so 2^15 of them stay below 2^63 in int64
_PLAIN_BLOCK = 1 << 15

#: launches of the CUDA kernel (bumped only where it is launched)
LAUNCHES = build.LaunchCount()


def _check_bytes(buf: torch.Tensor) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise TypeError(f"checksum: want a flat uint8 tensor, got {buf.dtype} {tuple(buf.shape)}")
    if not buf.is_contiguous():
        raise ValueError("checksum: buffer must be contiguous")


def checksum_words_plain(buf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on any device: int64 arithmetic, masked to
    32 bits every 2^15 words, so nothing leans on signed overflow.
    Returns int64 ``[s1, s2]``."""
    _check_bytes(buf)
    n = buf.numel()
    nwords = -(-n // 4)
    nblocks = max(1, -(-nwords // _PLAIN_BLOCK))
    raw = torch.zeros(nblocks * _PLAIN_BLOCK * 4, dtype=torch.uint8, device=buf.device)
    raw[:n] = buf
    # little-endian words, as on the host and the card
    words = (raw.view(torch.int32).to(torch.int64) & _MASK32).view(nblocks, _PLAIN_BLOCK)
    # block size 2^15 divides 2^16, so the weight of column j in block k
    # is ((k * 2^15 + j) & 0xFFFF) + 1
    idx = torch.arange(nblocks * _PLAIN_BLOCK, dtype=torch.int64, device=buf.device)
    weights = ((idx & 0xFFFF) + 1).view(nblocks, _PLAIN_BLOCK)
    s1 = (words.sum(dim=1) & _MASK32).sum() & _MASK32
    s2 = ((words * weights).sum(dim=1) & _MASK32).sum() & _MASK32
    return torch.stack([s1, s2])


def _num_blocks(device: torch.device, nbytes: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    # 256 threads a block, 16 bytes a thread a step; 8 blocks an SM
    # fill the card, fewer for a small buffer
    return max(1, min(sms * 8, -(-nbytes // (256 * 16))))


def checksum_words(buf: torch.Tensor) -> torch.Tensor:
    """``(s1, s2)`` of a flat contiguous uint8 tensor, on its device, as a
    2-element tensor (int32 bits of the uint32 sums on CUDA, int64 on the
    CPU); asynchronous on CUDA."""
    _check_bytes(buf)
    if buf.device.type == "cpu":
        return checksum_words_plain(buf)
    if buf.device.type != "cuda":
        raise TypeError(f"checksum: unsupported device {buf.device}")
    out = torch.zeros(2, dtype=torch.int32, device=buf.device)
    if buf.numel() == 0:
        return out
    lib = build.library()
    LAUNCHES.add()
    err = lib.th_checksum(
        buf.data_ptr(), buf.numel(), out.data_ptr(),
        _num_blocks(buf.device, buf.numel()), build.stream_ptr(buf.device),
    )
    build.check("th_checksum", err)
    return out


def fold(sums: torch.Tensor) -> int:
    """``(s2 << 32) | s1`` as a Python int (synchronizes)."""
    s1, s2 = (int(v) & _MASK32 for v in sums.tolist())
    return (s2 << 32) | s1
