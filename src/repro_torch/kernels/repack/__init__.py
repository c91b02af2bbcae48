"""Staged reshard repack on the device: scatter staging runs into a unit.

``gather_bytes(staging, runs, out_nbytes)`` assembles a destination
transfer unit's payload (uint8 ``[out_nbytes]``) from the staging buffer
a resharded pull landed its interval reads in: each ``(staging_offset,
unit_offset, nbytes)`` run moves to its place, and bytes no run covers
are 0. On a CUDA tensor it launches the hand-written kernel
(``csrc/repack.cu``, which replaces the Pallas kernel
``repro/kernels/repack/kernel.py:gather_bytes``) or raises; on a CPU
tensor it runs :func:`repack_plain`. The kernel takes the run triples
themselves, not the per-byte index map the Pallas kernel gathered through.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

#: ``(staging_offset, unit_offset, nbytes)``
Run = Tuple[int, int, int]

#: launches of the CUDA kernel (bumped only where it is launched)
LAUNCHES = build.LaunchCount()

_THREADS = 256
#: blocks the launch aims for in all (about 8 resident 256-thread
#: blocks on each of 132 SMs, eight times over)
_TARGET_BLOCKS = 8192


def _check(staging: torch.Tensor, runs: Sequence[Run], out_nbytes: int) -> None:
    if staging.dtype != torch.uint8 or staging.dim() != 1:
        raise TypeError(
            f"gather_bytes: want a flat uint8 staging tensor, got {staging.dtype} "
            f"{tuple(staging.shape)}"
        )
    if out_nbytes < 0:
        raise ValueError(f"gather_bytes: negative output size {out_nbytes}")
    for s_off, d_off, nbytes in runs:
        if nbytes < 0 or d_off < 0 or d_off + nbytes > out_nbytes:
            raise ValueError(f"run out of range: {(s_off, d_off, nbytes)}")
        if s_off < 0 or s_off + nbytes > staging.numel():
            raise ValueError(f"staging read out of range: {(s_off, d_off, nbytes)}")


def covers(spans: Sequence[Tuple[int, int]], out_nbytes: int) -> bool:
    """Whether ``(offset, nbytes)`` spans leave no byte of ``[0,
    out_nbytes)`` uncovered (only then may the output skip its zero fill)."""
    pos = 0
    for off, nbytes in sorted(spans):
        if off > pos:
            return False
        pos = max(pos, off + nbytes)
    return pos >= out_nbytes


def repack_plain(staging: torch.Tensor, runs: Sequence[Run], out_nbytes: int) -> torch.Tensor:
    """Plain PyTorch version on any device: zeros, then one slice copy per
    run (the JAX package's ``repack_np``)."""
    _check(staging, runs, out_nbytes)
    out = torch.zeros(out_nbytes, dtype=torch.uint8, device=staging.device)
    for s_off, d_off, nbytes in runs:
        out[d_off : d_off + nbytes] = staging[s_off : s_off + nbytes]
    return out


def gather_bytes(staging: torch.Tensor, runs: Sequence[Run], out_nbytes: int) -> torch.Tensor:
    """The unit payload (uint8 ``[out_nbytes]``, on ``staging``'s device)."""
    _check(staging, runs, out_nbytes)
    if staging.device.type == "cpu":
        return repack_plain(staging, runs, out_nbytes)
    if staging.device.type != "cuda":
        raise TypeError(f"gather_bytes: unsupported device {staging.device}")
    live = [r for r in runs if r[2] > 0]
    covered = covers([(d, n) for _, d, n in live], out_nbytes)
    alloc = torch.empty if covered else torch.zeros
    out = alloc(out_nbytes, dtype=torch.uint8, device=staging.device)
    if not live:
        return out
    table = torch.tensor(live, dtype=torch.int64).to(staging.device)  # one host-to-device copy
    blocks_y = min(len(live), 65535)
    longest = max(n for _, _, n in live)
    blocks_x = max(1, min(-(-longest // (_THREADS * 16)), _TARGET_BLOCKS // blocks_y))
    lib = build.library()
    LAUNCHES.add()
    err = lib.th_gather_bytes(
        staging.data_ptr(), out.data_ptr(), table.data_ptr(), len(live), blocks_x, blocks_y,
        build.stream_ptr(staging.device),
    )
    build.check("th_gather_bytes", err)
    return out


def random_runs(seed: int, out_nbytes: int, max_runs: int = 12) -> List[Run]:
    """A random exact tiling of ``[0, out_nbytes)`` for kernel checks: the
    output cut into runs, each read from its own staging range (staging
    is the runs concatenated in shuffled order). The JAX package's
    ``random_instructions`` idea, with Python's generator."""
    rng = random.Random(seed)
    n_runs = rng.randint(1, max_runs)
    cuts = sorted({0, out_nbytes} | {rng.randint(1, max(1, out_nbytes - 1)) for _ in range(n_runs)})
    spans = [(a, b - a) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
    rng.shuffle(spans)
    runs, pos = [], 0
    for d_off, nbytes in spans:
        runs.append((pos, d_off, nbytes))
        pos += nbytes
    return runs
