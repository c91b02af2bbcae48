"""End-to-end transfer checksums (4.6).

TensorHub attaches a per-unit checksum to every published reference and
validates it after transfer. We use a position-weighted Fletcher-style fold
over 32-bit words:

    s1 = sum(w_i)                 mod 2^32
    s2 = sum(((i & 0xffff)+1) * w_i) mod 2^32
    checksum = (s2 << 32) | s1

The position weight catches reordering/offset bugs that a plain sum misses.
A non-empty buffer whose fold lands on exactly 0 is remapped to
:data:`ZERO_STANDIN`: the transfer layer uses checksum 0 as the
"verification disabled" sentinel (divergent-manifest pulls), and a
colliding real payload — e.g. symmetric constant data whose weighted
sums cancel — must not silently disarm end-to-end verification.

The value is bit-identical to the JAX package's host checksum; the sums
run where the bytes live, through :mod:`repro_torch.kernels.checksum`
(the CUDA kernel for a tensor on the card, its plain version on the CPU).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.checksum import checksum_words, fold

#: stand-in for a non-empty buffer folding to exactly 0 — any fixed
#: non-zero value works (the induced collision class is the same
#: ~2^-64 as the fold itself)
ZERO_STANDIN = 0x5EED_0000_0000_5EED


def checksum(buf: torch.Tensor) -> int:
    """64-bit fold checksum of a tensor's bytes, on its device (see
    module docstring). Callers on the data plane pass flat uint8 views."""
    buf = buf.reshape(-1).view(torch.uint8)
    if buf.numel() == 0:
        return 0
    return fold(checksum_words(buf)) or ZERO_STANDIN


def combine(chunks: list[int]) -> int:
    """Order-sensitive combination of per-chunk checksums (for chunked
    verification paths): a second-level fold over the chunk checksums."""
    mask = 0xFFFFFFFFFFFFFFFF
    acc = 0
    for i, c in enumerate(chunks):
        w = c & mask
        acc = (acc + ((i & 0xFFFF) + 1) * (w ^ (w >> 32))) & mask
    return acc
