"""Decoder blocks: GQA attention, the SwiGLU MLP and the routed MoE FFN.

The port's copy of the JAX package's ``models/blocks.py`` without MLA.
Each block takes its parameters as a dict of views
(one layer's slice of the stacked tensors a replica registers). Matmuls
run in the activation dtype (bf16 on the serving path); norms, rotary
angles and the attention's softmax statistics in f32. A softcapped
config (gemma2) caps the attention scores at ``cfg.attn_softcap`` and
norms each block's output with its ``post_ln`` before the residual.

The MoE FFN (``moe_apply``) is the JAX package's sort-based capacity
dispatch: gathers, scatters and three batched expert products, in plain
PyTorch (the JAX package computes it with XLA ops outside any Pallas
kernel). ``moe_apply_shardmap``, its expert-parallel form, needs a mesh
and is not ported.

Only the default path of the JAX package's ``models/optim.py`` is ported:
``shard_attn_heads`` (broadcast K/V to the query heads and shard on them)
and ``lowp_norm`` are off there, and one card needs neither.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm, swiglu

Params = Dict[str, torch.Tensor]


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1).transpose(1, 2)  # [B, H, S, hd]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def attn_apply(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    *,
    positions: torch.Tensor,  # [S]
    attention: Callable[..., torch.Tensor],
    window: int = 0,  # this layer's sliding window (0: global)
    cache: Optional[Dict[str, torch.Tensor]] = None,  # decode: {"k","v"} [B, Hkv, Smax, hd]
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (block output incl. residual, the cache or the fresh K/V).

    Decode (``cache`` given) writes this step's K/V into the cache in
    place at ``cache_len`` (the JAX package's ``dynamic_update_slice``
    returns a new cache; writing into the preallocated one saves a copy of
    the whole cache a step) and attends over its first ``cache_len + S``
    slots. ``attention`` is called with ``causal``, ``softcap`` and
    ``window`` (and ``q_offset``, ``kv_len`` in decode)."""
    h = rms_norm(x, p["ln"])
    q = _split_heads(h @ p["wq"], cfg.num_heads)
    k = _split_heads(h @ p["wk"], cfg.num_kv_heads)
    v = _split_heads(h @ p["wv"], cfg.num_kv_heads)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kw = dict(causal=True, softcap=cfg.attn_softcap, window=window)
    if cache is None:
        out = attention(q, k, v, **kw)
        new_cache = {"k": k, "v": v}
    else:
        assert cache_len is not None
        s = q.shape[2]
        cache["k"][:, :, cache_len : cache_len + s] = k
        cache["v"][:, :, cache_len : cache_len + s] = v
        out = attention(q, cache["k"], cache["v"], q_offset=cache_len, kv_len=cache_len + s, **kw)
        new_cache = cache
    proj = _merge_heads(out) @ p["wo"]
    if "post_ln" in p:
        proj = rms_norm(proj, p["post_ln"])
    return x + proj, new_cache


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    out = swiglu(rms_norm(x, p["ln"]), p["w_gate"], p["w_up"], p["w_down"])
    if "post_ln" in p:
        out = rms_norm(out, p["post_ln"])
    return x + out


# ---------------------------------------------------------------------------
# Routed MoE (sort-based capacity dispatch)
# ---------------------------------------------------------------------------


def moe_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """One MoE layer's parameter shapes by name, as the JAX package's
    ``moe_specs``: norm, router, the experts' SwiGLU weights and, with
    ``num_shared``, the always-on shared expert's."""
    mo = cfg.moe
    assert mo is not None
    d, E, fe = cfg.d_model, mo.num_experts, mo.d_expert
    out = {"ln": (d,), "router": (d, E), "w_gate": (E, d, fe), "w_up": (E, d, fe), "w_down": (E, fe, d)}
    if mo.num_shared:
        fs = fe * mo.num_shared
        out.update(shared_gate=(d, fs), shared_up=(d, fs), shared_down=(fs, d))
    return out


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Rows an expert takes in a call of ``tokens`` tokens: the JAX
    package's rule, ``tokens * top_k / num_experts * capacity_factor``
    (at least 1) rounded up to a multiple of 8."""
    mo = cfg.moe
    cap = max(int(tokens * mo.top_k / mo.num_experts * mo.capacity_factor), 1)
    return (cap + 7) // 8 * 8


def route(
    cfg: ModelConfig, p: Params, flat: torch.Tensor, experts: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(top_p [T, k] f32, top_e [T, k])`` of normed tokens ``flat [T, D]``:
    router logits cast to f32, softmax, top-k, the k probabilities
    renormalised to sum to 1. ``torch.topk`` orders tied probabilities as it
    likes, ``jax.lax.top_k`` by index; continuous inputs do not tie.
    ``experts [T, k]``, when given, are taken in place of the top-k (a
    replay that follows another run's routing), weighted by this call's
    own probabilities."""
    probs = torch.softmax((flat @ p["router"]).float(), dim=-1)
    if experts is None:
        top_p, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    else:
        top_p, top_e = probs.gather(-1, experts), experts
    return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def dispatch(top_e: torch.Tensor, num_experts: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, dest)`` of the ``T * k`` (token, slot) pairs of ``top_e``
    (pair ``i`` is token ``i // k``'s slot ``i % k``): ``order`` sorts them
    by expert, stably (as ``jnp.argsort``: which pairs overflow depends on
    it), and ``dest[j]`` is sorted pair ``j``'s row of the ``[E * cap]``
    expert buffer, its expert's first free row, or the waste row ``E * cap``
    once the expert holds ``cap`` pairs (dropped)."""
    e_flat = top_e.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    ar = torch.arange(e_flat.numel(), device=e_flat.device)
    group_start = torch.searchsorted(e_sorted, torch.arange(num_experts, device=e_flat.device, dtype=e_sorted.dtype))
    pos_in_e = ar - group_start[e_sorted]  # each pair's place in its expert's group
    return order, torch.where(pos_in_e < cap, e_sorted * cap + pos_in_e, num_experts * cap)


class DroppedPairs:
    """The (token, slot) pairs ``moe_apply`` routed and those it dropped
    over capacity, summed over its calls. ``routed`` is a host integer;
    the dropped count is summed on each device without a host sync (so
    counting costs a decode step nothing), and ``dropped`` synchronizes."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def add(self, routed: int, dropped: torch.Tensor) -> None:
        with self._lock:
            self.calls += 1
            self.routed += routed
            key = dropped.device
            self._dropped[key] = self._dropped[key] + dropped if key in self._dropped else dropped

    def reset(self) -> None:
        with self._lock:
            self.calls, self.routed, self._dropped = 0, 0, {}

    @property
    def dropped(self) -> int:
        with self._lock:
            return sum(int(t) for t in self._dropped.values())


#: every ``moe_apply`` call's routed and dropped pairs
DROPPED = DroppedPairs()


def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Token-choice top-k with a per-expert capacity, as the JAX package's
    ``moe_apply``: the ``T * k`` (token, slot) pairs are sorted by expert
    (a stable sort, as ``jnp.argsort``: which pairs overflow depends on
    it), placed into an ``[E, cap, D]`` buffer (pairs past an expert's
    capacity go to a waste row and are dropped), the experts' SwiGLU runs
    as three batched products over all ``E * cap`` rows, and each pair's
    output, weighted by its probability, is summed into its token in f32.

    The combine is deterministic where the JAX package's is a scatter-add
    (``index_add_`` on the card adds with atomics, so its f32 sums may
    differ in the last bit from run to run): each pair's output is gathered
    in pair order, viewed ``[T, k, D]`` and summed over the slots in slot
    order. The k terms are the JAX package's; with k = 2 the sums are its
    bits, with larger k they may differ in the last bit (it adds in
    expert order)."""
    mo = cfg.moe
    assert mo is not None
    b, s, d = x.shape
    t, k, E = b * s, mo.top_k, mo.num_experts
    cap = capacity(cfg, t)

    h = rms_norm(x, p["ln"])
    flat = h.reshape(t, d)
    top_p, top_e = route(cfg, p, flat)

    order, dest = dispatch(top_e, E, cap)
    DROPPED.add(t * k, (dest == E * cap).sum())

    buf = flat.new_zeros(E * cap + 1, d).index_put((dest,), flat[order // k])
    grouped = buf[: E * cap].view(E, cap, d)

    # the experts' SwiGLU over every row of every expert
    g = torch.bmm(grouped, p["w_gate"])
    u = torch.bmm(grouped, p["w_up"])
    y = torch.bmm(F.silu(g) * u, p["w_down"])

    # each pair's output in pair order (token * k + slot), weighted, then
    # summed over the slots in order, in f32
    y_flat = torch.cat([y.reshape(E * cap, d), y.new_zeros(1, d)])
    dest_by_pair = torch.empty_like(dest).scatter_(0, order, dest)
    contrib = (y_flat[dest_by_pair] * top_p.reshape(-1, 1).to(y.dtype)).view(t, k, d).float()
    combined = contrib[:, 0]
    for j in range(1, k):
        combined = combined + contrib[:, j]
    out = combined.to(x.dtype)

    if mo.num_shared:
        out = out + swiglu(flat, p["shared_gate"], p["shared_up"], p["shared_down"])
    return x + out.view(b, s, d)


def moe_dense_ref(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The O(T * E) oracle of the JAX package's ``moe_dense_ref``: every
    expert runs on every token and the top-k gates mask the combine (no
    capacity, nothing dropped). For tests on small configs."""
    mo = cfg.moe
    assert mo is not None
    b, s, d = x.shape
    flat = rms_norm(x, p["ln"]).reshape(-1, d)
    top_p, top_e = route(cfg, p, flat)
    gates = torch.zeros(flat.shape[0], mo.num_experts, dtype=torch.float32, device=x.device).scatter(1, top_e, top_p)
    g = torch.einsum("td,edf->tef", flat, p["w_gate"])
    u = torch.einsum("td,edf->tef", flat, p["w_up"])
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, p["w_down"])
    out = torch.einsum("ted,te->td", y.float(), gates).to(x.dtype)
    if mo.num_shared:
        out = out + swiglu(flat, p["shared_gate"], p["shared_up"], p["shared_down"])
    return x + out.view(b, s, d)
