"""The Mamba2 (SSD) block of the hybrid family (zamba2): the chunked scan
for training and prefill, the one-token recurrence for decode (arXiv:2405.21060).

The port's copy of the JAX package's ``models/ssd.py``, in plain PyTorch
(the JAX package computes it with XLA ops outside any Pallas kernel).
Per head h, with head size P and state size N:

    S_t = exp(dt_t * A_h) * S_{t-1} + (dt_t * x_t) outer B_t      [P, N]
    y_t = S_t @ C_t + D_h * x_t

:func:`_ssd_chunked` cuts the sequence into chunks of ``chunk`` steps: an
attention-like masked product within a chunk, then the chunks' final
states carried from chunk to chunk. The JAX package takes ``exp(li - lj)``
over the whole chunk and masks afterwards; above the diagonal ``li - lj``
is a sum of ``-dt * a > 0``, which at the published chunk of 256 reaches
~176 at the init values and overflows f32 to ``inf``. The forward keeps 0
there, but the backward multiplies a zero cotangent by ``inf`` and every
gradient with respect to ``dt`` turns NaN. Here the exponent is masked
before the exp (``exp(-inf) = 0``): the same forward, a finite gradient,
which :func:`ssd_reference` (the step-by-step oracle, with no overflow)
checks.

The f32 islands are the JAX package's: dt, a, the decays, the states, the
conv sums and the ``y * silu(z)`` gate in f32, cast back to the
activations' dtype where it casts. ``softplus`` is ``jax.nn.softplus``'s
``logaddexp(x, 0)`` (``torch.nn.functional.softplus`` returns ``x`` itself
above its threshold of 20).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import LocalHeads
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamSpec, spec

Params = Dict[str, torch.Tensor]


def ssd_dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """``(d_inner, heads, head size P, state size N, conv channels)``."""
    s = cfg.ssm
    assert s is not None
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.head_dim, s.d_state, d_in + 2 * s.d_state


def ssd_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """One block's specs by name, as the JAX package's ``ssd_specs``:
    ``w_in`` projects to ``[z (d_in), xBC (d_in + 2N), dt (heads)]``."""
    s = cfg.ssm
    assert s is not None
    d = cfg.d_model
    d_in, nheads, _, n, conv_dim = ssd_dims(cfg)
    return {
        "ln": spec((d,), ("act_embed",), init="zeros"),
        "w_in": spec((d, 2 * d_in + 2 * n + nheads), ("embed", "ssm_inner")),
        "conv_w": spec((s.d_conv, conv_dim), ("conv", "ssm_inner")),
        "conv_b": spec((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": spec((nheads,), ("ssm_heads",), init="zeros"),
        "d_skip": spec((nheads,), ("ssm_heads",), init="ones"),
        "dt_bias": spec((nheads,), ("ssm_heads",), init="zeros"),
        "norm": spec((d_in,), ("ssm_inner",), init="zeros"),
        "w_out": spec((d_in, d), ("ssm_inner", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssd_chunked(
    x: torch.Tensor,  # [B, T, H, P]
    dt: torch.Tensor,  # [B, T, H] (post-softplus)
    a: torch.Tensor,  # [H] (negative)
    bmat: torch.Tensor,  # [B, T, N]
    cmat: torch.Tensor,  # [B, T, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y [B, T, H, P] in x's dtype, final state [B, H, P, N]
    f32)``. The within-chunk weights are laid out ``[B, chunks, H, L, L]``
    so that their product with ``dt * x`` is one batched matmul."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    L = min(chunk, t)
    nc = -(-t // L)
    pad = nc * L - t
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    xc = x.reshape(b, nc, L, h, p)
    dtc = dt.reshape(b, nc, L, h).float()
    bc = bmat.reshape(b, nc, L, n).float()
    cc = cmat.reshape(b, nc, L, n).float()

    cum = torch.cumsum(dtc * a.float(), dim=2)  # inclusive cumulative log decay [B, nc, L, H] (negative)
    total = cum[:, :, -1]  # [B, nc, H]
    dx = dtc[..., None] * xc.float()  # [B, nc, L, H, P]

    # within a chunk: the causal, attention-like term, the exponent masked
    # before the exp
    g = torch.einsum("bcln,bcmn->bclm", cc, bc)  # [B, nc, L, L]
    ch = cum.transpose(2, 3)  # [B, nc, H, L]
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((ch[..., :, None] - ch[..., None, :]).masked_fill(~causal, float("-inf")))
    w = g[:, :, None] * decay  # [B, nc, H, L, L]
    y_intra = (w @ dx.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)  # [B, nc, L, H, P]

    # each chunk's final state: S_c = sum_j exp(total - cum_j) dx_j outer b_j
    decay_to_end = torch.exp(total[:, :, None] - cum)  # [B, nc, L, H]
    s_chunk = torch.einsum("bclhp,bcln->bchpn", decay_to_end[..., None] * dx, bc)

    # carried across chunks: S_prev_{c+1} = exp(total_c) S_prev_c + S_c
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if init_state is None else init_state.float()
    prevs = []
    # the chunks taken apart once (a chunk's slice would give every chunk's backward a zero tensor of all of them)
    for decay_c, s_c in zip(torch.exp(total)[..., None, None].unbind(1), s_chunk.unbind(1)):
        prevs.append(s)
        s = decay_c * s + s_c
    s_prevs = torch.stack(prevs, dim=1)  # [B, nc, H, P, N]

    # from the chunks before: y_inter[i] = exp(cum_i) * C_i . S_prev
    y_inter = torch.einsum("bcln,bchpn->bclhp", cc, s_prevs) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * L, h, p)[:, :t]
    return y.to(x.dtype), s


def ssd_reference(x, dt, a, bmat, cmat, init_state=None):
    """The step-by-step recurrence (the oracle the tests hold
    :func:`_ssd_chunked` to): ``(y [B, T, H, P] in x's dtype, final
    state f32)``."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if init_state is None else init_state.float()
    ys = []
    for i in range(t):
        decay = torch.exp(dt[:, i].float() * a)  # [B, H]
        dx = dt[:, i, :, None].float() * x[:, i].float()
        s = decay[:, :, None, None] * s + torch.einsum("bhp,bn->bhpn", dx, bmat[:, i].float())
        ys.append(torch.einsum("bhpn,bn->bhp", s, cmat[:, i].float()))
    return torch.stack(ys, dim=1).to(x.dtype), s


def _conv_sum(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor, seq: int, dtype) -> torch.Tensor:
    """``silu(sum_i window[:, i : i + seq] w[i] + b)`` in f32, cast to
    ``dtype``: the depthwise conv over ``K - 1 + seq`` positions."""
    out = torch.zeros((window.shape[0], seq, window.shape[2]), dtype=torch.float32, device=window.device)
    for i in range(w.shape[0]):
        out = out + window[:, i : i + seq].float() * w[i].float()
    return F.silu(out + b.float()).to(dtype)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, zeros before the first step.
    xbc: ``[B, T, C]``; w: ``[K, C]``."""
    return _conv_sum(F.pad(xbc, (0, 0, w.shape[0] - 1, 0)), w, b, xbc.shape[1], xbc.dtype)


def ssd_block_apply(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"conv": [B, K-1, conv_dim], "state": [B, H, P, N]}
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (block output incl. residual, the new cache). Without a
    cache: the causal conv and the chunked scan from a zero state, and the
    new cache holds the last ``K - 1`` pre-conv ``xBC`` rows (left-padded
    with zeros when ``S < K - 1``) and the final state. With a cache: the
    conv over the cached rows and this call's (an f32 cache promotes the
    window to f32, as JAX's type promotion does), then the one-step
    recurrence for ``S == 1`` or the chunked scan from the cached state.
    The cache given is not written; the caller stores the new one.

    On DTensors (the sharded steps) the projections and the gated norm run
    on DTensors and the rest on each rank's block
    (:class:`~repro_torch.models.blocks.LocalHeads`: its batch, its heads).
    ``w_in``'s packed columns ``[z | xBC | dt]`` are sharded evenly over
    the model axis, across the boundaries of the three and of the heads,
    so the projection is gathered whole over the model axis (one all-gather
    of ``[B, S, 2 d_in + 2N + H]`` a rank's batch) and each rank takes its
    heads' columns of z, x and dt and all of B and C, which every head
    reads (their gradient summed over the model axis); the conv runs on
    those channels only, the cached conv rows gathered whole likewise. The
    scan runs on ``[B/dp, T, H/tp, P]``; the gated norm's mean over
    ``d_in`` is DTensor's reduction across the ranks' heads."""
    s = cfg.ssm
    assert s is not None
    d_in, nheads, hd, n, conv_dim = ssd_dims(cfg)
    bsz, seq, _ = x.shape
    k = p["conv_w"].shape[0]

    h = rms_norm(x, p["ln"])
    proj = h @ p["w_in"]
    blk = LocalHeads(proj, bsz, nheads)
    h0, h1 = blk.heads
    whole = (h0, h1) == (0, nheads)
    proj = blk.local(proj, shared=True)  # this rank's batch, every column
    z, xbc_raw, dt_raw = torch.split(proj, [d_in, conv_dim, nheads], dim=-1)

    def mine(t: torch.Tensor) -> torch.Tensor:
        """The channels this rank's heads read: its heads' x and all of B and C."""
        return t if whole else torch.cat([t[..., h0 * hd : h1 * hd], t[..., d_in:]], dim=-1)

    conv_w = mine(blk.local(p["conv_w"], batch_dim=None, shared=True))
    conv_b = mine(blk.local(p["conv_b"], batch_dim=None, shared=True))
    if cache is None:
        xbc = _causal_conv(mine(xbc_raw), conv_w, conv_b)
        if seq >= k - 1:
            new_conv = xbc_raw[:, seq - (k - 1) :]
        else:
            new_conv = F.pad(xbc_raw, (0, 0, k - 1 - seq, 0))
    else:
        cached = blk.local(cache["conv"])
        wide = torch.promote_types(cached.dtype, xbc_raw.dtype)
        window = torch.cat([cached.to(wide), xbc_raw.to(wide)], dim=1)  # [B, K-1+S, C]
        xbc = _conv_sum(mine(window), conv_w, conv_b, seq, x.dtype)
        new_conv = window[:, -(k - 1) :]

    xs, bmat, cmat = torch.split(xbc, [(h1 - h0) * hd, n, n], dim=-1)
    xs = xs.reshape(proj.shape[0], seq, h1 - h0, hd)
    dt = softplus(dt_raw[..., h0:h1].float() + blk.local(p["dt_bias"], batch_dim=None, head_dim=0).float())
    a = -torch.exp(blk.local(p["a_log"], batch_dim=None, head_dim=0).float())

    if cache is None or seq > 1:
        init = None if cache is None else blk.local(cache["state"], head_dim=1)
        y, state = _ssd_chunked(xs, dt, a, bmat, cmat, s.chunk, init)
    else:  # one step of the recurrence
        decay = torch.exp(dt[:, 0] * a)  # [B, H]
        dx = dt[:, 0, :, None] * xs[:, 0].float()
        state = decay[:, :, None, None] * blk.local(cache["state"], head_dim=1).float() + torch.einsum(
            "bhp,bn->bhpn", dx, bmat[:, 0].float())
        y = torch.einsum("bhpn,bn->bhp", state, cmat[:, 0].float())[:, None].to(x.dtype)

    d_skip = blk.local(p["d_skip"], batch_dim=None, head_dim=0)
    y = y.float() + d_skip.float()[None, None, :, None] * xs.float()
    y = y.reshape(xs.shape[0], seq, (h1 - h0) * hd)
    gated = blk.placed((y * F.silu(z[..., h0 * hd : h1 * hd].float())).to(x.dtype), head_dim=2)
    y = rms_norm(gated, p["norm"])
    return x + y @ p["w_out"], {"conv": blk.placed(new_conv), "state": blk.placed(state.float(), head_dim=1)}
