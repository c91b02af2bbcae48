"""Transformer building blocks of the decoder and the encoder (plain
PyTorch).

The port's copy of the JAX package's ``models/layers.py``: ``rms_norm``
(with its H2 branch, ``lowp_norm``), ``softcap``, the split-half rotary
embedding, the SwiGLU MLP and the encoder's GELU MLP. The attention itself is
:func:`repro_torch.kernels.flash_attention.flash_attention`, which keeps
the semantics of the JAX package's jnp ``chunked_attention`` (``q_offset``
places the queries, ``kv_len`` counts the valid cache slots, ``window`` is
the sliding window of a local layer, ``softcap`` the attention softcap).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import optim


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + gamma`` scale (zero-initialised
    gamma is the identity scale), cast back to x's dtype. Under H2
    (``optim.FLAGS.lowp_norm``) a non-f32 input keeps the variance in f32
    but is scaled in its own dtype, ``x * scale * (1 + gamma)`` with both
    factors rounded to it, as the JAX package's: no f32 copy of x is
    scaled. An f32 input takes the f32 path either way."""
    dt = x.dtype
    xf = x.float()
    scale = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if optim.FLAGS.lowp_norm and dt != torch.float32:
        return x * scale.to(dt) * (1.0 + gamma.float()).to(dt)
    return ((xf * scale) * (1.0 + gamma.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, D] (D even); positions: broadcastable to [..., S]. The
    split-half convention: the first and second halves of D rotate as
    the two coordinates of each pair."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # [D/2]
    angles = positions[..., None].float() * freqs  # [..., S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor, w_down: torch.Tensor,
             b_down: torch.Tensor) -> torch.Tensor:
    """The encoder's MLP (hubert): ``gelu(x @ w_up + b_up) @ w_down +
    b_down`` with GELU's tanh form, which ``jax.nn.gelu`` computes by
    default (``approximate=True``); torch's default is the exact erf form,
    up to ~1e-3 away from it."""
    return F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down + b_down
