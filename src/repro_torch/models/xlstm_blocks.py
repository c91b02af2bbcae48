"""The xLSTM blocks of the SSM family (xlstm-350m, arXiv:2405.04517): the
mLSTM (matrix memory, parallelizable) and the sLSTM (scalar memory,
strictly sequential).

The port's copy of the JAX package's ``models/xlstm_blocks.py``, in plain
PyTorch (the JAX package computes it with XLA ops outside any Pallas
kernel). Both blocks carry a stabiliser state ``m`` so the exponential
gating stays finite. The mLSTM has three forms that compute the same
function: the quadratic parallel form (:func:`_mlstm_parallel`), the
chunked form that is linear in T (:func:`_mlstm_chunked`: within a chunk
the parallel form, across chunks a carried matrix state) and the one-step
recurrence (:func:`_mlstm_step`); :func:`_mlstm_fold_state` gives the
state after a whole sequence. The sLSTM is a loop over time with head-wise
recurrent matrices.

The arithmetic is the JAX package's: q, k, v and the gates are cast to f32
inside the scans and every state is f32; a block's output is cast back to
the activations' dtype before its down projection; ``silu(z)`` is computed
in f32 and rounded once to the activations' dtype. The stabilisers start at
-1e30 (not -inf), chunk padding appends ``i = -1e30`` and ``f = +1e30`` in
the gates' dtype ("add nothing", "keep everything"), and the causal mask is
applied as ``-inf`` before the exp. The stabiliser maxima are
``torch.amax``, whose gradient splits evenly between ties as ``jnp.max``'s
does (``Tensor.max(dim)`` gives it all to one index).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import LocalHeads, batch_placed
from repro_torch.models.optim import is_dtensor
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamSpec, spec

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]

#: the stabiliser's starting value (the JAX package's "-inf-ish")
M_START = -1e30
#: the chunked mLSTM's steps a chunk (the JAX package's)
MLSTM_CHUNK = 256


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """``(d_in, heads, head size)`` of the mLSTM block."""
    x = cfg.xlstm
    assert x is not None
    d_in = int(cfg.d_model * x.proj_factor)
    heads = cfg.num_heads
    return d_in, heads, d_in // heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """One mLSTM block's specs by name, as the JAX package's
    ``mlstm_specs``: ``w_up`` projects to ``[x (d_in), z (d_in)]``,
    ``w_if``'s columns are ``(2, heads)``, the input gate first."""
    d = cfg.d_model
    d_in, h, _ = mlstm_dims(cfg)
    return {
        "ln": spec((d,), ("act_embed",), init="zeros"),
        "w_up": spec((d, 2 * d_in), ("embed", "ssm_inner")),
        "wq": spec((d_in, d_in), ("ssm_inner", None)),
        "wk": spec((d_in, d_in), ("ssm_inner", None)),
        "wv": spec((d_in, d_in), ("ssm_inner", None)),
        "w_if": spec((d_in, 2 * h), ("ssm_inner", "ssm_heads")),
        "b_if": spec((2 * h,), ("ssm_heads",), init="zeros"),
        "w_down": spec((d_in, d), ("ssm_inner", "embed")),
    }


def _causal(t: int, device) -> torch.Tensor:
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def _mlstm_parallel(q, k, v, i_raw, f_raw) -> torch.Tensor:
    """q, k, v: ``[B, H, T, Dh]``; i_raw, f_raw: ``[B, H, T]``. Returns
    ``[B, H, T, Dh]`` in q's dtype: the quadratic form."""
    dh = q.shape[-1]
    log_f = F.logsigmoid(f_raw.float())
    cum = torch.cumsum(log_f, dim=-1)  # F_t
    # d[t, s] = F_t - F_s + i_s   (s <= t)
    dmat = cum[..., :, None] - cum[..., None, :] + i_raw.float()[..., None, :]
    dmat = dmat.masked_fill(~_causal(q.shape[2], q.device), float("-inf"))
    m = torch.amax(dmat, dim=-1)  # [B, H, T] running max
    dstab = torch.exp(dmat - m[..., None])
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores / math.sqrt(dh) * dstab
    b = scores.sum(dim=-1)  # [B, H, T]
    denom = torch.maximum(b.abs(), torch.exp(-m))
    out = (scores @ v.float()) / denom[..., None]
    return out.to(q.dtype)


def _mlstm_zero_state(b: int, h: int, dh: int, device) -> State:
    return {
        "c": torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((b, h, dh), dtype=torch.float32, device=device),
        "m": torch.full((b, h), M_START, dtype=torch.float32, device=device),
    }


def _mlstm_chunked(q, k, v, i_raw, f_raw, *, chunk: int = MLSTM_CHUNK,
                   init: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """The chunked mLSTM: within a chunk the parallel form, across chunks
    the recurrent matrix state, tracked stabilised (``C_hat = C exp(-m)``,
    ``n_hat = n exp(-m)``). Returns ``(out [B, H, T, Dh] in q's dtype,
    the final state {"c", "n", "m"} f32)``; ``init`` is the state to start
    from (a zero state with ``m = -1e30`` when None)."""
    b, h, t, dh = q.shape
    L = min(chunk, t)
    nc = -(-t // L)
    pad = nc * L - t
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        # padded steps: the forget gate keeps everything (log_f = 0 at raw
        # +1e30), the input gate adds nothing (i = -1e30)
        i_raw = F.pad(i_raw, (0, pad), value=M_START)
        f_raw = F.pad(f_raw, (0, pad), value=-M_START)

    qc = q.reshape(b, h, nc, L, dh).float()
    kc = k.reshape(b, h, nc, L, dh).float()
    vc = v.reshape(b, h, nc, L, dh).float()
    ic = i_raw.reshape(b, h, nc, L).float()
    fc = f_raw.reshape(b, h, nc, L).float()
    scale = 1.0 / math.sqrt(dh)
    causal = _causal(L, q.device)

    if init is None:
        state = _mlstm_zero_state(b, h, dh, q.device)
    else:
        state = {n: init[n].float() for n in ("c", "n", "m")}
    c_hat, n_hat, m_prev = state["c"], state["n"], state["m"]
    outs: List[torch.Tensor] = []
    # the chunks taken apart once (a chunk's slice would give every chunk's backward a zero tensor of all of them)
    for qq, kk, vv, ii, ff in zip(*(t.unbind(2) for t in (qc, kc, vc, ic, fc))):  # [B, H, L, (Dh)]
        log_f = F.logsigmoid(ff)
        cum = torch.cumsum(log_f, dim=-1)  # F_t within the chunk
        # the local pairwise weights d[t, s] = F_t - F_s + i_s (s <= t)
        dmat = (cum[..., :, None] - cum[..., None, :] + ii[..., None, :]).masked_fill(~causal, float("-inf"))
        m_local = torch.amax(dmat, dim=-1)  # [B, H, L]
        m_inter = cum + m_prev[..., None]  # the state's weight: F_t + m_prev
        m_t = torch.maximum(m_local, m_inter)
        dstab = torch.exp(dmat - m_t[..., None])
        scores = (qq @ kk.transpose(-1, -2)) * scale * dstab
        inter_w = torch.exp(m_inter - m_t)  # [B, H, L]
        q_c = (qq @ c_hat) * scale
        q_n = (qq @ n_hat[..., None])[..., 0] * scale
        num = scores @ vv + inter_w[..., None] * q_c
        den = scores.sum(dim=-1) + inter_w * q_n
        outs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # the end-of-chunk state fold
        total = cum[..., -1:]  # F_L
        w = total - cum + ii  # the weight of step s in the final state
        m_new = torch.maximum(total[..., 0] + m_prev, torch.amax(w, dim=-1))
        ws = torch.exp(w - m_new[..., None])
        carry = torch.exp(total[..., 0] + m_prev - m_new)
        c_hat = carry[..., None, None] * c_hat + (ws[..., None] * kk).transpose(-1, -2) @ vv
        n_hat = carry[..., None] * n_hat + (ws[..., None] * kk).sum(dim=-2)
        m_prev = m_new
    out = torch.stack(outs, dim=2).reshape(b, h, nc * L, dh)[:, :, :t]
    return out.to(q.dtype), {"c": c_hat, "n": n_hat, "m": m_prev}


def _mlstm_step(state: State, q, k, v, i_raw, f_raw) -> Tuple[torch.Tensor, State]:
    """One step of the recurrence: q, k, v ``[B, H, Dh]``, the gates ``[B,
    H]``. Returns ``(h [B, H, Dh] in q's dtype, the new state f32)``."""
    dh = q.shape[-1]
    c, n, m = state["c"], state["n"], state["m"]  # [B, H, Dh, Dh], [B, H, Dh], [B, H]
    log_f = F.logsigmoid(f_raw.float())
    i32 = i_raw.float()
    m_new = torch.maximum(log_f + m, i32)
    f_s = torch.exp(log_f + m - m_new)
    i_s = torch.exp(i32 - m_new)
    kf, vf = k.float(), v.float()
    c = f_s[..., None, None] * c + i_s[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = f_s[..., None] * n + i_s[..., None] * kf
    qf = q.float() / math.sqrt(dh)
    b = (qf * n).sum(dim=-1)
    denom = torch.maximum(b.abs(), torch.exp(-m_new))
    h = (qf[..., None, :] @ c)[..., 0, :] / denom[..., None]
    return h.to(q.dtype), {"c": c, "n": n, "m": m_new}


def _mlstm_fold_state(q, k, v, i_raw, f_raw) -> State:
    """The final ``(C, n, m)`` after consuming the whole sequence at once
    (the state :func:`_mlstm_parallel` leaves behind)."""
    log_f = F.logsigmoid(f_raw.float())
    cum = torch.cumsum(log_f, dim=-1)
    total = cum[..., -1:]
    w = total - cum + i_raw.float()  # the log-weight of step s in the final state
    m = torch.amax(w, dim=-1)  # [B, H]
    ws = torch.exp(w - m[..., None])
    kf, vf = k.float(), v.float()
    wk = ws[..., None] * kf
    return {"c": wk.transpose(-1, -2) @ vf, "n": wk.sum(dim=-2), "m": m}


def mlstm_block_apply(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    *,
    cache: Optional[State] = None,
    form: str = "chunked",
    chunk: int = MLSTM_CHUNK,
) -> Tuple[torch.Tensor, State]:
    """Returns (block output incl. residual, the new state). ``S > 1`` runs
    the chunked form (``chunk`` steps a chunk) from ``cache`` (a zero state
    when None), ``S == 1``
    one step of the recurrence. ``form="parallel"`` runs a cacheless call
    of ``S > 1`` on the quadratic form instead, its state folded by
    :func:`_mlstm_fold_state` (a reference for the chunked form). The cache
    given is not written; the caller stores the new state.

    On DTensors (the sharded steps) the projections run on DTensors (``w_up``'s
    ``[x | z]`` split where DTensor places it) and the recurrence on each
    rank's block of the batch and the heads
    (:class:`~repro_torch.models.blocks.LocalHeads`), its state too."""
    d_in, nh, dh = mlstm_dims(cfg)
    bsz, seq, _ = x.shape
    h = rms_norm(x, p["ln"])
    up = h @ p["w_up"]
    xm, z = up.split(d_in, dim=-1)

    blk = LocalHeads(xm, bsz, nh)
    h0, h1 = blk.heads

    def heads(t: torch.Tensor) -> torch.Tensor:  # [B, S, H * dh] -> this rank's [B, H, S, dh]
        t = blk.local(t, head_dim=2)
        return t.reshape(t.shape[0], seq, h1 - h0, dh).transpose(1, 2)

    q, k, v = heads(xm @ p["wq"]), heads(xm @ p["wk"]), heads(xm @ p["wv"])
    # w_if's columns are gate-major (2, heads): whole, then this rank's heads
    gates = blk.local(xm @ p["w_if"] + p["b_if"], shared=True).reshape(-1, seq, 2, nh)[..., h0:h1]
    i_raw, f_raw = gates.permute(0, 3, 1, 2).unbind(-1)  # [B, H, T] each
    if cache is not None:
        cache = {n: blk.local(t, head_dim=1) for n, t in cache.items()}

    if seq > 1 and form == "parallel":
        if cache is not None:
            raise ValueError("mlstm: the parallel form starts from no cache")
        out, state = _mlstm_parallel(q, k, v, i_raw, f_raw), _mlstm_fold_state(q, k, v, i_raw, f_raw)
    elif seq > 1:
        # chunked: O(T) memory, the form that scales to long context
        out, state = _mlstm_chunked(q, k, v, i_raw, f_raw, chunk=chunk, init=cache)
    else:
        state = cache if cache is not None else _mlstm_zero_state(q.shape[0], q.shape[1], dh, q.device)
        o, state = _mlstm_step(state, q[:, :, 0], k[:, :, 0], v[:, :, 0], i_raw[:, :, 0], f_raw[:, :, 0])
        out = o[:, :, None]
    merged = blk.placed(out.transpose(1, 2).reshape(out.shape[0], seq, (h1 - h0) * dh), head_dim=2)
    y = merged * F.silu(z.float()).to(x.dtype)
    return x + y @ p["w_down"], {n: blk.placed(t, head_dim=1) for n, t in state.items()}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """One sLSTM block's specs by name, as the JAX package's
    ``slstm_specs``: ``w_gates``' columns are ``(4, heads, head size)`` in
    z, i, f, o order; ``r_gates`` ``[4, heads, dh, dh]`` is contracted over
    its third axis and drawn at half the fan-in std."""
    d = cfg.d_model
    nh = cfg.num_heads
    dh = d // nh
    return {
        "ln": spec((d,), ("act_embed",), init="zeros"),
        "w_gates": spec((d, 4 * d), ("embed", "ssm_inner")),  # z,i,f,o
        "b_gates": spec((4 * d,), ("ssm_inner",), init="zeros"),
        "r_gates": spec((4, nh, dh, dh), (None, "ssm_heads", None, None), scale=0.5),
        "w_out": spec((d, d), ("ssm_inner", "embed")),
    }


def slstm_zero_state(b: int, h: int, dh: int, device) -> State:
    z = (b, h, dh)
    return {"h": torch.zeros(z, dtype=torch.float32, device=device),
            "c": torch.zeros(z, dtype=torch.float32, device=device),
            "n": torch.zeros(z, dtype=torch.float32, device=device),
            "m": torch.full(z, M_START, dtype=torch.float32, device=device)}


def slstm_block_apply(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    *,
    cache: Optional[State] = None,
) -> Tuple[torch.Tensor, State]:
    """Returns (block output incl. residual, the new state ``{"h", "c",
    "n", "m"}`` f32). One step a position, each step's recurrent products
    of the four gates one batched product over the heads (``r_gates``
    regrouped once to ``[H, dh, 4 dh]``); the hidden outputs are collected
    in a list and stacked. The cache given is not written. On DTensors the
    projections run on DTensors and the loop on each rank's block of the
    batch and the heads (:class:`~repro_torch.models.blocks.LocalHeads`):
    plain tensors, each step's ops never dispatched through DTensor."""
    d = cfg.d_model
    nh = cfg.num_heads
    dh = d // nh
    bsz, seq, _ = x.shape
    inp = rms_norm(x, p["ln"])
    if is_dtensor(inp) and sum(q.is_shard(0) for q in inp.placements) > 1:
        # a batch split over two mesh dimensions (a multi-pod prefill), placed by the batch alone: PyTorch 2.11's
        # DTensor cannot take it into this product as it lies ("redistribute from S(0) to P(sum)")
        inp = batch_placed(inp)
    gates_x = inp @ p["w_gates"] + p["b_gates"]
    blk = LocalHeads(gates_x, bsz, nh)
    h0, h1 = blk.heads
    # the columns are gate-major (4, heads, dh): whole, then this rank's heads
    gates_x = blk.local(gates_x, shared=True).reshape(-1, seq, 4, nh, dh)[:, :, :, h0:h1].float()
    b_loc, nh_loc = gates_x.shape[0], h1 - h0
    if cache is not None:
        state = {n: blk.local(t, head_dim=1) for n, t in cache.items()}
    else:
        state = slstm_zero_state(b_loc, nh_loc, dh, x.device)
    # rec[g, b, h, e] = sum_d r[g, h, d, e] h_prev[b, h, d], as one [H, B, dh] @ [H, dh, 4 dh]
    r = blk.local(p["r_gates"], batch_dim=None, head_dim=1).float().permute(1, 2, 0, 3).reshape(nh_loc, dh, 4 * dh)
    h_prev, c_prev, n_prev, m_prev = (state[n].float() for n in ("h", "c", "n", "m"))
    hs: List[torch.Tensor] = []
    # each step's gates taken apart once (a step's slice would give every step's backward a zero tensor of
    # all the steps' gates)
    for gx in gates_x.unbind(1):
        rec = (h_prev.transpose(0, 1) @ r).view(nh_loc, b_loc, 4, dh).permute(1, 2, 0, 3)  # [B, 4, H, dh]
        gz, gi, gf, go = (gx + rec).unbind(1)
        z = torch.tanh(gz)
        log_f = F.logsigmoid(gf)
        m_new = torch.maximum(log_f + m_prev, gi)
        i_s = torch.exp(gi - m_new)
        f_s = torch.exp(log_f + m_prev - m_new)
        c_prev = f_s * c_prev + i_s * z
        n_prev = f_s * n_prev + i_s
        h_prev = torch.sigmoid(go) * (c_prev / torch.clamp(n_prev, min=1e-6))
        m_prev = m_new
        hs.append(h_prev)
    out = blk.placed(torch.stack(hs, dim=1).reshape(b_loc, seq, nh_loc * dh), head_dim=2).to(x.dtype)
    new = {"h": h_prev, "c": c_prev, "n": n_prev, "m": m_prev}
    return x + out @ p["w_out"], {n: blk.placed(t, head_dim=1) for n, t in new.items()}
