"""Dense decoder blocks: GQA attention and the SwiGLU MLP.

The port's copy of the dense part of the JAX package's
``models/blocks.py``. Each block takes its parameters as a dict of views
(one layer's slice of the stacked tensors a replica registers). Matmuls
run in the activation dtype (bf16 on the serving path); norms, rotary
angles and the attention's softmax statistics in f32. A softcapped
config (gemma2) caps the attention scores at ``cfg.attn_softcap`` and
norms each block's output with its ``post_ln`` before the residual.

Only the default path of the JAX package's ``models/optim.py`` is ported:
``shard_attn_heads`` (broadcast K/V to the query heads and shard on them)
and ``lowp_norm`` are off there, and one card needs neither.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

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
