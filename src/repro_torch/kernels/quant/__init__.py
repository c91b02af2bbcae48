"""Symmetric per-row int8 quantization on the device (the int8 wire codec).

``quantize_rows(x)`` quantizes a flat bf16, f16 or f32 tensor in rows of
256 elements (a ragged last row is zero-padded):

    scale = max(absmax / 127, 1e-12)
    q     = clip(rint(x / scale), -127, 127)

and returns ``(q int8 [rows * 256], scales f32 [rows])``. On a CUDA tensor
it launches the hand-written kernel (``csrc/quant.cu``, which replaces
the Pallas kernel ``repro/kernels/quant/kernel.py:quantize_rows``) or
raises; on a CPU tensor it runs :func:`quantize_rows_plain`. Both equal
the JAX package's NumPy reference bit for bit.

:func:`dequantize_rows` is plain PyTorch: the JAX package's decode is a
NumPy expression, not a kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

ROW_LEN = 256

#: kernel dtype codes (csrc/quant.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: launches of the CUDA kernel (bumped only where it is launched)
LAUNCHES = build.LaunchCount()


def _check_input(x: torch.Tensor) -> None:
    if x.dtype not in _CODES or x.dim() != 1:
        raise TypeError(
            f"quantize_rows: want a flat float32/bfloat16/float16 tensor, got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("quantize_rows: input must be contiguous")
    if x.numel() == 0:
        raise ValueError("quantize_rows: empty input")


def quantize_rows_plain(
    x: torch.Tensor, row_len: int = ROW_LEN
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version on any device, op for op the NumPy reference
    (``amax``, ``/ 127``, ``clamp_min(1e-12)``, ``round``, ``clamp``).
    The divisors are tensors on ``x``'s device, never Python scalars:
    CUDA turns division by a host scalar into a reciprocal multiply, which
    can round a scale 1 ulp away from IEEE division."""
    _check_input(x)
    n = x.numel()
    rows = -(-n // row_len)
    xf = torch.zeros(rows * row_len, dtype=torch.float32, device=x.device)
    xf[:n] = x
    xf = xf.view(rows, row_len)
    absmax = xf.abs().amax(dim=1)
    scales = (absmax / torch.full_like(absmax, 127.0)).clamp_min(1e-12)
    q = torch.round(xf / scales[:, None]).clamp(-127, 127).to(torch.int8)
    return q.view(-1), scales


def quantize_rows(x: torch.Tensor, row_len: int = ROW_LEN) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 [rows * row_len], scales f32 [rows])`` of a flat tensor."""
    _check_input(x)
    if x.device.type == "cpu":
        return quantize_rows_plain(x, row_len)
    if x.device.type != "cuda":
        raise TypeError(f"quantize_rows: unsupported device {x.device}")
    if row_len != ROW_LEN:
        raise ValueError(f"quantize_rows: the CUDA kernel quantizes rows of {ROW_LEN}, not {row_len}")
    n = x.numel()
    rows = -(-n // ROW_LEN)
    q = torch.empty(rows * ROW_LEN, dtype=torch.int8, device=x.device)
    scales = torch.empty(rows, dtype=torch.float32, device=x.device)
    lib = build.library()
    LAUNCHES.add()
    err = lib.th_quantize_rows(
        x.data_ptr(), _CODES[x.dtype], n, q.data_ptr(), scales.data_ptr(), rows,
        build.stream_ptr(x.device),
    )
    build.check("th_quantize_rows", err)
    return q, scales


def dequantize_rows(
    q: torch.Tensor, scales: torch.Tensor, n: int, dtype: torch.dtype, row_len: int = ROW_LEN
) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` for the first ``n`` elements:
    ``(q * scale)`` in f32 per row, rounded to ``dtype`` (RNE), flat.
    ``q`` may hold just the ``n`` true elements (the wire form)."""
    rows = scales.numel()
    qp = torch.zeros(rows * row_len, dtype=torch.int8, device=q.device)
    qp[: q.numel()] = q
    x = qp.view(rows, row_len).to(torch.float32).mul_(scales[:, None]).view(-1)
    return x[:n].to(dtype)
