"""Fused dequant + gather: int8 wire frames -> repacked unit payload.

The staged reshard decode would materialize every interval twice: decode
the int8 frame into a staging buffer, then repack (gather) staging bytes
into the destination unit's layout. This module fuses the two: each
frame's rows that cover its interval are dequantized straight into the
interval's place in the unit payload, and the row-grid ``lead``/``tail``
widening is never decoded.

:func:`fused_repack` on frames that lie on a CUDA device launches the
hand-written kernel (``csrc/fused.cu``, which replaces the Pallas kernel
``repro/kernels/quant/fused.py:dequant_gather``) or raises; on the CPU
it runs :func:`fused_repack_plain`. The kernel is driven by one
descriptor per placement (pointers into the parsed frames, offsets,
row length, dtype): no concatenation of the frames and no per-element
index maps. Every placement runs in it: mixed dtypes in one unit, f64
(an f32 product widened exactly) and placements that are not
element-aligned (stored byte by byte). Passthrough frames (non-finite
payloads, unquantizable bytes) are copied over the result afterwards.

Both paths are bit-identical to the JAX package's ``fused_repack_np``:
an f32 product ``q * scale`` rounded once, then a round-to-nearest-even
downcast.

Frames arrive parsed (:func:`repro_torch.transfer.codec.parse_int8_frame`),
so header/scale/shape validation happened exactly once, at the transport
boundary.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.meta import dtype_from_str
from repro_torch.kernels import build
from repro_torch.kernels.repack import covers

#: placement of one parsed frame in the destination unit payload:
#: (frame, lead, nbytes, unit_offset) — write frame bytes
#: [lead, lead + nbytes) at out[unit_offset : unit_offset + nbytes]
Placement = Tuple[object, int, int, int]

#: kernel dtype codes (csrc/fused.cu)
_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "float64": 3}

#: launches of the CUDA kernel (bumped only where it is launched)
LAUNCHES = build.LaunchCount()

_THREADS = 256
#: blocks the launch aims for in all (see ``kernels/repack``)
_TARGET_BLOCKS = 8192


def _dequant_span(frame, lead: int, nbytes: int) -> torch.Tensor:
    """Dequantize exactly the rows of ``frame`` that cover byte span
    [lead, lead + nbytes) and return those bytes (no whole-frame staging
    decode). Op for op the JAX package's ``_dequant_span``."""
    dtype = dtype_from_str(frame.dtype)
    isz = dtype.itemsize
    rb = frame.row_len * isz
    r0 = lead // rb
    r1 = -(-(lead + nbytes) // rb)
    n = frame.nbytes // isz  # true element count of the frame
    e0 = r0 * frame.row_len
    e1 = min(r1 * frame.row_len, n)
    cnt = e1 - e0
    if cnt == (r1 - r0) * frame.row_len:
        qv = frame.q[e0:e1]  # full rows: no ragged-tail pad needed
    else:
        qv = torch.zeros((r1 - r0) * frame.row_len, dtype=torch.int8, device=frame.q.device)
        qv[:cnt] = frame.q[e0:e1]
    x = qv.reshape(r1 - r0, frame.row_len).to(torch.float32)
    x *= frame.scales[r0:r1, None]  # in place: the same f32 multiply, one pass
    x = x.reshape(-1)[:cnt]
    if dtype != torch.float32:
        x = x.to(dtype)
    dec = x.contiguous().view(torch.uint8)
    off = lead - r0 * rb
    return dec[off : off + nbytes]


def _device_of(placements: Sequence[Placement], device) -> torch.device:
    devs = {
        (f.passthrough if f.is_passthrough else f.q).device
        for f, _, nbytes, _ in placements
        if nbytes > 0
    }
    if device is not None:
        devs.add(torch.device(device))
    if len(devs) > 1:
        raise ValueError(f"fused_repack: frames on several devices {sorted(map(str, devs))}")
    return devs.pop() if devs else torch.device("cpu")


def fused_repack_plain(
    placements: Sequence[Placement], out_nbytes: int, *, device=None
) -> torch.Tensor:
    """Plain PyTorch version on any device, op for op the JAX package's
    ``fused_repack_np``: each frame's covered rows dequantize straight
    into their repacked output span."""
    out = torch.zeros(out_nbytes, dtype=torch.uint8, device=_device_of(placements, device))
    for frame, lead, nbytes, uo in placements:
        if nbytes <= 0:
            continue
        if frame.is_passthrough:
            out[uo : uo + nbytes] = frame.passthrough[lead : lead + nbytes]
        else:
            out[uo : uo + nbytes] = _dequant_span(frame, lead, nbytes)
    return out


def _check(placements: Sequence[Placement], out_nbytes: int) -> None:
    for frame, lead, nbytes, uo in placements:
        if nbytes <= 0:
            continue
        if lead < 0 or lead + nbytes > frame.nbytes:
            raise ValueError(f"placement reads frame bytes [{lead}, {lead + nbytes}) of {frame.nbytes}")
        if uo < 0 or uo + nbytes > out_nbytes:
            raise ValueError(f"placement writes [{uo}, {uo + nbytes}) of a {out_nbytes}B unit")
        if not frame.is_passthrough and frame.dtype not in _CODES:
            raise TypeError(f"fused_repack: unsupported frame dtype {frame.dtype}")


def dequant_gather(
    placements: Sequence[Placement], out_nbytes: int, device: torch.device
) -> torch.Tensor:
    """Launch the CUDA kernel over the quantized placements: the unit
    payload (uint8 ``[out_nbytes]`` on ``device``) with every quantized
    span decoded and every byte no placement covers 0. Passthrough spans
    are left for the caller to overlay."""
    if device.type != "cuda":
        raise TypeError(f"dequant_gather: the kernel runs on a CUDA device, not {device}")
    live = [p for p in placements if p[2] > 0]
    covered = covers([(uo, nbytes) for _, _, nbytes, uo in live], out_nbytes)
    out = (torch.empty if covered else torch.zeros)(out_nbytes, dtype=torch.uint8, device=device)
    quant = [p for p in live if not p[0].is_passthrough]
    if not quant:
        return out
    rows = [
        (f.q.data_ptr(), f.scales.data_ptr(), lead, nbytes, f.row_len, uo, _CODES[f.dtype], 0)
        for f, lead, nbytes, uo in quant
    ]
    table = torch.tensor(rows, dtype=torch.int64).to(device)  # one host-to-device copy
    blocks_y = min(len(quant), 65535)
    most = max(nbytes for _, _, nbytes, _ in quant)  # a thread per byte at worst
    blocks_x = max(1, min(-(-most // _THREADS), _TARGET_BLOCKS // blocks_y))
    lib = build.library()
    LAUNCHES.add()
    err = lib.th_dequant_gather(
        table.data_ptr(), len(quant), out.data_ptr(), blocks_x, blocks_y, build.stream_ptr(device)
    )
    build.check("th_dequant_gather", err)
    return out


def fused_repack(
    placements: Sequence[Placement], out_nbytes: int, *, device: Optional[torch.device] = None
) -> torch.Tensor:
    """The destination unit's payload (uint8 ``[out_nbytes]``) from its
    parsed int8 frames, on the frames' device (or ``device``)."""
    _check(placements, out_nbytes)
    dev = _device_of(placements, device)
    if dev.type == "cpu":
        return fused_repack_plain(placements, out_nbytes, device=dev)
    if dev.type != "cuda":
        raise TypeError(f"fused_repack: unsupported device {dev}")
    out = dequant_gather(placements, out_nbytes, dev)
    # passthrough frames overlay their exact bytes after the kernel
    for frame, lead, nbytes, uo in placements:
        if frame.is_passthrough and nbytes > 0:
            out[uo : uo + nbytes].copy_(frame.passthrough[lead : lead + nbytes])
    return out


__all__ = [
    "LAUNCHES",
    "dequant_gather",
    "fused_repack",
    "fused_repack_plain",
]
