"""Decoder blocks: GQA attention (bidirectional for the encoder),
multi-head latent attention (MLA), the SwiGLU MLP and the routed MoE FFN.

The port's copy of the JAX package's ``models/blocks.py``.
Each block takes its parameters as a dict of views
(one layer's slice of the stacked tensors a replica registers). Matmuls
run in the activation dtype (bf16 on the serving path); norms, rotary
angles and the attention's softmax statistics in f32. A softcapped
config (gemma2) caps the attention scores at ``cfg.attn_softcap`` and
norms each block's output with its ``post_ln`` before the residual.

Each block's parameter schema is a ``<block>_specs(cfg)`` dict of
:class:`~repro_torch.models.params.ParamSpec` (shape, logical sharding
axes, init), as the JAX package's.

The MoE FFN (``moe_apply``) is the JAX package's sort-based capacity
dispatch: gathers, scatters and three batched expert products, in plain
PyTorch (the JAX package computes it with XLA ops outside any Pallas
kernel). On DTensors (H3 off) its dispatch is placed (:func:`_moe_placed`):
each rank sorts its own tokens' pairs, the JAX package's global capacity
and dropped pairs kept by one all-gather of per-expert counts, and the
expert buffer is summed over the batch axes where the expert weights lie;
the tokens are never gathered whole. ``moe_apply_shardmap`` is its
expert-parallel form (the JAX package's H3, :mod:`repro_torch.models.optim`)
over ``torch.distributed``: each rank dispatches its own tokens to its own
experts with a capacity of its own, and one ``all_reduce`` over the model
axis combines them.

Of the JAX package's ``models/optim.py``, all three are ported:
``lowp_norm`` (H2, in :func:`~repro_torch.models.layers.rms_norm`),
``shard_attn_heads`` (H1, in :func:`attn_apply`: K/V broadcast to the
query heads and the attention placed on them) and ``shardmap_moe`` (H3).

Parameters and activations may be DTensors on a ``DeviceMesh`` (the
sharded train and serving steps', :func:`repro_torch.sharding.place_tree`).
The attention then runs on each rank's local block (:func:`_attend`; MLA's
on its block of the batch and the query heads, :class:`_HeadBlocks`), so
the attention function is handed plain tensors, a decode step's cache
included (written in place on the local blocks, :func:`write_at`), and H3
on each rank's local tokens and experts. The recurrences of the hybrid and
the xLSTM run on each rank's block of the batch and the heads likewise
(:class:`LocalHeads`).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import optim
from repro_torch.models.layers import apply_rope, rms_norm, swiglu
from repro_torch.models.params import ParamSpec, spec

Params = Dict[str, torch.Tensor]


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """One GQA attention layer's specs, as the JAX package's ``attn_specs``
    (a softcapped model also post-norms the block's output)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    out = {
        "ln": spec((d,), ("act_embed",), init="zeros"),
        "wq": spec((d, cfg.num_heads * hd), ("embed", "q_heads")),
        "wk": spec((d, cfg.num_kv_heads * hd), ("embed", "kv_heads")),
        "wv": spec((d, cfg.num_kv_heads * hd), ("embed", "kv_heads")),
        "wo": spec((cfg.num_heads * hd, d), ("q_heads", "embed")),
    }
    if cfg.attn_softcap > 0:  # gemma2 also post-norms the block output
        out["post_ln"] = spec((d,), ("act_embed",), init="zeros")
    return out


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    if optim.is_dtensor(x):  # a width sharded over more ranks than it has heads is gathered first
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        keep = [p if not (p.is_shard(2) and n % mesh.size(i)) else Replicate() for i, p in enumerate(x.placements)]
        if keep != list(x.placements):
            x = x.redistribute(mesh, keep)
    return x.reshape(b, s, n, -1).transpose(1, 2)  # [B, H, S, hd]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    out = x.transpose(1, 2).reshape(b, s, h * hd)
    if optim.is_dtensor(out):  # the reshape's backward takes the cotangent as the reshape left its output
        out = _GradPlacedLike.apply(out)
    return out


class _GradPlacedLike(torch.autograd.Function):
    """The identity on a DTensor whose backward redistributes the
    cotangent to the placements the forward's tensor had. After
    :func:`_merge_heads`' reshape: the output projection's backward may
    hand back a cotangent sharded along the merged heads, over more ranks
    than there are heads (deepseek-coder-33b's and yi-34b's 56 on a 16-way
    model axis), which the reshape's backward cannot split into heads;
    the forward kept that width whole (:func:`_split_heads`), and so does
    its cotangent then."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        if optim.is_dtensor(grad) and tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def attn_apply(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    *,
    positions: torch.Tensor,  # [S]
    attention: Callable[..., torch.Tensor],
    causal: bool = True,  # False: the encoder's bidirectional attention
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
    kw = dict(causal=causal, softcap=cfg.attn_softcap, window=window)
    if cache is None:
        # H1 (repro_torch.models.optim): broadcast K/V to the query heads
        # (each KV head repeated ``g`` times, the order of ``jnp.repeat``)
        # and place everything on the query heads, which divide the model
        # axis where the KV heads may not
        ka, va = k, v
        if optim.broadcast_kv_active():
            g = cfg.num_heads // cfg.num_kv_heads
            if g > 1:
                ka, va = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
            q, ka, va = optim.shard_attn(q), optim.shard_attn(ka), optim.shard_attn(va)
        out = optim.shard_attn(_attend(attention, q, ka, va, **kw))
        new_cache = {"k": k, "v": v}
    else:
        assert cache_len is not None
        s = q.shape[2]
        write_at(cache["k"], k, 2, cache_len)
        write_at(cache["v"], v, 2, cache_len)
        out = _attend(attention, q, cache["k"], cache["v"], q_offset=cache_len, kv_len=cache_len + s, h1=False, **kw)
        new_cache = cache
    proj = _merge_heads(out) @ p["wo"]
    if "post_ln" in p:
        proj = rms_norm(proj, p["post_ln"])
    return x + proj, new_cache


def _attend(attention: Callable[..., torch.Tensor], q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            h1: bool = True, **kw) -> torch.Tensor:
    """``attention(q, k, v, **kw)``; DTensors attend on each rank's local
    block. Under H1 that is ``[B/dp, H/tp, S, hd]``: q, k and v placed on
    the query heads by :func:`optim.shard_attn`. Without it the attention
    runs on k's own blocks (:func:`_kv_blocks`): k's batch as k lies, its
    KV heads over the model axis where they divide it, and the query heads
    in the same contiguous blocks, so a rank's ``G * Hkv / tp`` query
    heads are those of its ``Hkv / tp`` KV heads.
    ``h1=False`` (a decode step: a cache's KV heads, never broadcast) takes
    the second placement whatever the flags say. A decode step's cache
    then stays where it lies wherever the rules put its KV heads over the
    model axis. Where they put its head_dim there (KV heads that do not
    divide the model axis: llama3-8b's 8 on 16 ranks), the cache is
    gathered over that axis every step, layer by layer, as the JAX
    package's partitioner also gathers it. The attention function sees
    plain tensors; the result is a DTensor placed as its inputs."""
    if not optim.is_dtensor(q):
        return attention(q, k, v, **kw)
    from torch.distributed.tensor import DTensor

    mesh = q.device_mesh
    placements = q.placements if h1 and optim.broadcast_kv_active() else _kv_blocks(k)
    q, k, v = (t.redistribute(mesh, placements).to_local() for t in (q, k, v))
    return DTensor.from_local(attention(q, k, v, **kw), mesh, placements, run_check=False)


def _kv_blocks(k: torch.Tensor) -> tuple:
    """The placements of attention without H1, from k ``[B, Hkv, S, hd]``
    (a DTensor): its KV heads over the model axis where they divide it
    (:func:`optim.attn_spec`), its batch as k lies where k's batch is split
    evenly (a cache's, by the rules: over the data axis alone where the
    batch does not divide pod x data), else over the flags' batch axes
    where it divides them; every other dimension whole (a sharded slot or
    head_dim gathered, a partial sum reduced). Applied to q ``[B, G * Hkv,
    S, hd]`` too, whose heads then fall in the same contiguous blocks as
    their KV heads."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.rules import placements_for

    mesh = k.device_mesh
    placements = placements_for(optim.attn_spec(tuple(k.shape), mesh), mesh)
    lies = [i for i, p in enumerate(k.placements) if p.is_shard(0)]
    if lies and k.shape[0] % math.prod(mesh.size(i) for i in lies) == 0:
        placements = tuple(Shard(0) if i in lies else Replicate() if p.is_shard(0) else p
                           for i, p in enumerate(placements))
    return placements


class LocalHeads:
    """A recurrence on each rank's block where its tensors are DTensors
    (the SSD scan, the mLSTM and the sLSTM): the batch over the flags'
    batch axes where it divides them, the heads over the model axis where
    they divide it (:func:`optim.attn_spec`, as the attention's blocks),
    every other dimension whole. The recurrence runs on those blocks as
    plain tensors, never op by op through DTensor's dispatch, and its
    results are placed back as DTensors. On plain tensors every method is
    the identity and :attr:`heads` the whole range."""

    def __init__(self, like: torch.Tensor, batch: int, heads: int):
        self.mesh = like.device_mesh if optim.is_dtensor(like) else None
        #: this rank's heads, ``[first, end)``
        self.heads = (0, heads)
        if self.mesh is None:
            return
        self._batch, self._head = optim.attn_spec((batch, heads), self.mesh)
        if self._head is not None:
            n, r = self.mesh.size(self._dim(self._head)), self.mesh.get_local_rank(self._head)
            self.heads = (r * heads // n, (r + 1) * heads // n)

    def _dim(self, name: str) -> int:
        return tuple(self.mesh.mesh_dim_names).index(name)

    def _placements(self, ndim: int, batch_dim: Optional[int], head_dim: Optional[int]) -> tuple:
        from repro_torch.sharding.rules import placements_for

        spec: list = [None] * ndim
        if batch_dim is not None:
            spec[batch_dim] = self._batch
        if head_dim is not None:
            spec[head_dim] = self._head
        return placements_for(tuple(spec), self.mesh)

    def local(self, t: torch.Tensor, *, batch_dim: Optional[int] = 0, head_dim: Optional[int] = None,
              shared: bool = False) -> torch.Tensor:
        """``t``'s block of this rank's batch (along ``batch_dim``) and heads
        (along ``head_dim``) as a plain tensor (a plain ``t`` taken as
        replicated). ``shared``: a tensor that every head reads (the SSD's
        B and C, its packed projection, its conv weights) and each rank
        reads for its own heads only: its block's gradient is this rank's
        part, summed over the model axis where the heads are split. A
        tensor without a batch dimension (``batch_dim=None``: a parameter)
        is read by each rank for its own batch block: its gradient is
        summed over the batch axes where the batch is split."""
        if self.mesh is None:
            return t
        from torch.distributed.tensor import DTensor, Partial, Replicate

        if not optim.is_dtensor(t):
            t = DTensor.from_local(t, self.mesh, [Replicate()] * self.mesh.ndim, run_check=False)
        placements = self._placements(t.ndim, batch_dim, head_dim)
        summed = set()
        if shared and self._head is not None:
            summed.add(self._dim(self._head))
        if batch_dim is None and self._batch is not None:
            summed.update(self._dim(a) for a in ((self._batch,) if isinstance(self._batch, str) else self._batch))
        grad = tuple(Partial() if i in summed else p for i, p in enumerate(placements)) if summed else None
        return t.redistribute(self.mesh, placements).to_local(grad_placements=grad)

    def placed(self, t: torch.Tensor, *, batch_dim: Optional[int] = 0, head_dim: Optional[int] = None) -> torch.Tensor:
        """This rank's block ``t`` as a DTensor placed as :meth:`local`
        takes it."""
        if self.mesh is None:
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.mesh, self._placements(t.ndim, batch_dim, head_dim), run_check=False)


def store(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst`` set to ``src`` in place (a cache entry to a block's new
    state); a DTensor ``dst`` on each rank's block, ``src`` redistributed to
    its placements first (a plain ``src`` taken as replicated)."""
    if optim.is_dtensor(dst):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = dst.device_mesh
        if not optim.is_dtensor(src):
            src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
        src, dst = src.redistribute(mesh, dst.placements).to_local(), dst.to_local()
    dst.copy_(src)


def batch_placed(x: torch.Tensor) -> torch.Tensor:
    """A DTensor activation ``[B, ...]`` with its batch over the flags'
    batch axes where it divides them and every other dimension whole on
    every rank (the rules' ``("batch", "seq", "act_embed")``); a plain
    tensor as it is."""
    if not optim.is_dtensor(x):
        return x
    from repro_torch.sharding.rules import placements_for

    return x.redistribute(x.device_mesh, placements_for(optim.attn_spec(tuple(x.shape), x.device_mesh, heads=False),
                                                        x.device_mesh))


def write_at(dst: torch.Tensor, src: torch.Tensor, axis: int, start: int) -> None:
    """``dst``'s positions ``[start, start + n)`` along ``axis`` set to
    ``src`` (``n`` its length there), in place: a cache's slots. A DTensor
    ``dst`` (a cache placed on a mesh) is written on each rank's local
    block, ``src`` redistributed to ``dst``'s placements first (a plain
    ``src`` taken as replicated), but whole along ``axis``. A cache sharded
    along ``axis`` (the sequence-parallel cache of ``LONG_SERVE_RULES``, a
    block of slots a rank) is written by each rank where its block meets
    ``[start, start + n)``, and by no rank elsewhere: a prefill's first
    slots, a ring's one slot."""
    if optim.is_dtensor(dst):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        mesh = dst.device_mesh
        if not optim.is_dtensor(src):
            src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
        whole = [Replicate() if p.is_shard(axis) else p for p in dst.placements]
        src = src.redistribute(mesh, whole).to_local()
        local, offset = compute_local_shape_and_global_offset(dst.shape, mesh, dst.placements)
        dst = dst.to_local()
        lo, hi = max(start, offset[axis]), min(start + src.shape[axis], offset[axis] + local[axis])
        if lo >= hi:  # this rank's block of slots misses the range
            return
        src = src.narrow(axis, lo - start, hi - lo)
        start = lo - offset[axis]
    dst.narrow(axis, start, src.shape[axis]).copy_(src)


# ---------------------------------------------------------------------------
# Multi-head latent attention (deepseek-v3)
# ---------------------------------------------------------------------------


def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """One MLA layer's specs by name, as the JAX package's ``mla_specs``:
    the queries through a low-rank path (``wq_a``, its norm ``q_ln``,
    ``wq_b`` to H heads of ``qk_nope + qk_rope``), the shared KV latent and
    the decoupled rope key (``wkv_a``, the latent's norm ``kv_ln``), the
    latent's up-projections to each head's keys and values (``wkv_b_k``,
    ``wkv_b_v``) and the output projection."""
    m = cfg.mla
    assert m is not None
    d, H = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "ln": spec((d,), ("act_embed",), init="zeros"),
        "wq_a": spec((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_ln": spec((m.q_lora_rank,), ("q_lora",), init="zeros"),
        "wq_b": spec((m.q_lora_rank, H * qk_head), ("q_lora", "q_heads")),
        "wkv_a": spec((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "kv_lora")),
        "kv_ln": spec((m.kv_lora_rank,), ("kv_lora",), init="zeros"),
        "wkv_b_k": spec((m.kv_lora_rank, H * m.qk_nope_head_dim), ("kv_lora", "q_heads")),
        "wkv_b_v": spec((m.kv_lora_rank, H * m.v_head_dim), ("kv_lora", "q_heads")),
        "wo": spec((H * m.v_head_dim, d), ("q_heads", "embed")),
    }


def mla_scale(cfg: ModelConfig) -> float:
    """The absorbed form's softmax scale, ``1/sqrt(qk_nope + qk_rope)``
    computed in f32 as the JAX package computes it (the expanded form's
    flash attention takes ``1/sqrt`` of q/k's width, the same width)."""
    m = cfg.mla
    width = torch.tensor(float(m.qk_nope_head_dim + m.qk_rope_head_dim), dtype=torch.float32)
    return float(1.0 / torch.sqrt(width))


def mla_apply(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    *,
    positions: torch.Tensor,  # [S]
    attention: Callable[..., torch.Tensor],
    latent_attention: Callable[..., torch.Tensor],
    cache: Optional[Dict[str, torch.Tensor]] = None,  # decode: {"ckv": [B, Smax, R], "krope": [B, Smax, rd]}
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (block output incl. residual, the cache or the fresh
    ``{"ckv", "krope"}``), as the JAX package's ``mla_apply``.

    Without a cache (prefill, ``forward``) the expanded form: each head's
    keys ``[k_nope | k_rope]`` (the rope key broadcast over the heads) and
    values are materialised from the latent and go with the queries
    ``[q_nope | q_rope]`` to ``attention`` (causal; q/k of ``qk_nope +
    qk_rope`` and v of ``v_head_dim``: the flash kernel's (192, 128) plan
    for deepseek-v3). The expanded form is also what training
    differentiates: autograd sums the broadcast rope key's per-head
    gradients back into ``wkv_a``, and the attention's backward is the
    flash kernels' at (192, 128) (bf16, tensor cores) or (24, 16) (the
    reduced config, CUDA cores). With a cache (decode) the absorbed form: the step's
    latent and rope key are written into the cache in place at
    ``cache_len`` (the JAX package's ``dynamic_update_slice`` returns a new
    cache), ``wkv_b_k`` is folded into the queries (``q_abs``, in the
    activation dtype, as JAX's einsum of two bf16 operands), and
    ``latent_attention`` (the ``mla_decode`` kernel's wrapper, or its plain
    version) scores them against the latent cache and returns the latent
    output in f32, which ``wkv_b_v`` takes to each head's values in f32
    (with TF32 off, as the port leaves it, this product is f32 as the
    reference's), cast to the activation dtype.

    On DTensors both forms run on each rank's block of the batch and of
    the query heads (:class:`_HeadBlocks`): the expanded form broadcasts
    the rope key over that rank's heads only (its gradient summed over the
    model axis), the absorbed form folds that rank's columns of
    ``wkv_b_k`` and ``wkv_b_v`` and scores against its batch block of the
    latent cache (placed ``("batch", "seq", "kv_lora")``, whole on every
    model rank): no collective that grows with the cache, only the output
    projection's partial sum."""
    m = cfg.mla
    assert m is not None
    b, s, _ = x.shape
    H, rd = cfg.num_heads, m.qk_rope_head_dim
    h = rms_norm(x, p["ln"])
    # queries through the low-rank path
    q_lat = rms_norm(h @ p["wq_a"], p["q_ln"])
    q = _split_heads(q_lat @ p["wq_b"], H)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, rd], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    # the kv latent and the decoupled rope key
    ckv, k_rope = (h @ p["wkv_a"]).split([m.kv_lora_rank, rd], dim=-1)
    ckv = rms_norm(ckv, p["kv_ln"])  # [B, S, R]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)  # [B, S, rd]

    blk = _HeadBlocks(q)
    if cache is None:
        k_nope = _split_heads(ckv @ p["wkv_b_k"], H)
        v = _split_heads(ckv @ p["wkv_b_v"], H)
        qk, k_nope, v = (blk.local(t) for t in (torch.cat([q_nope, q_rope], dim=-1), k_nope, v))
        kr = blk.local_rows(k_rope, summed=True)
        bl, hl = qk.shape[:2]
        k = torch.cat([k_nope, kr[:, None].expand(bl, hl, s, rd)], dim=-1)
        out = blk.placed(attention(qk, k, v, causal=True))
        return x + _merge_heads(out) @ p["wo"], {"ckv": ckv, "krope": k_rope}

    assert cache_len is not None
    write_at(cache["ckv"], ckv, 1, cache_len)
    write_at(cache["krope"], k_rope, 1, cache_len)
    q_nope, q_rope = blk.local(q_nope), blk.local(q_rope)
    hl = q_nope.shape[1]
    wk = blk.local_cols(p["wkv_b_k"]).reshape(m.kv_lora_rank, hl, m.qk_nope_head_dim)
    q_abs = torch.einsum("bhsd,rhd->bhsr", q_nope, wk)
    out_lat = latent_attention(q_abs, q_rope, blk.local_rows(cache["ckv"]), blk.local_rows(cache["krope"]),
                               kv_len=cache_len + s, scale=mla_scale(cfg))
    wv = blk.local_cols(p["wkv_b_v"]).reshape(m.kv_lora_rank, hl, m.v_head_dim).float()
    out = blk.placed(torch.einsum("bhsr,rhd->bhsd", out_lat, wv).to(x.dtype))
    return x + _merge_heads(out) @ p["wo"], cache


class _HeadBlocks:
    """MLA's attention on each rank's block of the batch and of the query
    heads, where its tensors are DTensors: the heads stay where its
    projections put them (``wq_b``, ``wkv_b_k`` and ``wkv_b_v`` are
    ``q_heads`` columns), over the model axis where they divide it, and the
    batch over the flags' batch axes (:func:`optim.attn_spec`). Unlike a
    dense GQA layer whose KV heads do not divide the model axis
    (:func:`_attend` without H1), nothing is gathered: MLA's K and V are
    per head and the latent and rope key whole on every model rank, so
    each rank builds its heads' keys from them. On plain tensors every
    method is the identity."""

    def __init__(self, q: torch.Tensor):
        self.mesh = q.device_mesh if optim.is_dtensor(q) else None
        if self.mesh is None:
            return
        from torch.distributed.tensor import Partial, Replicate, Shard

        from repro_torch.sharding.rules import placements_for

        self.heads = placements_for(optim.attn_spec(tuple(q.shape), self.mesh), self.mesh)
        #: a latent [B, S, *]'s: the batch as the heads' block, whole over the model axis
        self.rows = tuple(pl if pl.is_shard(0) else Replicate() for pl in self.heads)
        #: the gradient of a latent each rank broadcast over its own heads: partial where the heads are split
        self.rows_summed = tuple(Partial() if h.is_shard(1) else r for h, r in zip(self.heads, self.rows))
        #: an up-projection [R, H * w]'s: each rank's heads' columns
        self.cols = tuple(Shard(1) if h.is_shard(1) else Replicate() for h in self.heads)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """``[B, H, S, *]``'s block of this rank's batch and heads."""
        return t if self.mesh is None else t.redistribute(self.mesh, self.heads).to_local()

    def local_rows(self, t: torch.Tensor, *, summed: bool = False) -> torch.Tensor:
        """``[B, S, *]``'s block of this rank's batch (a cache's, in place:
        the serve rules place it so). ``summed``: the block's gradient is
        this rank's heads' part of the whole, summed over the model axis."""
        if self.mesh is None:
            return t
        return t.redistribute(self.mesh, self.rows).to_local(grad_placements=self.rows_summed if summed else None)

    def local_cols(self, w: torch.Tensor) -> torch.Tensor:
        """An up-projection's columns of this rank's heads."""
        return w if self.mesh is None else w.redistribute(self.mesh, self.cols).to_local()

    def placed(self, out: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``[B, H, S, *]`` as a DTensor."""
        if self.mesh is None:
            return out
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(out, self.mesh, self.heads, run_check=False)


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    """The SwiGLU MLP's specs (``d_ff`` the config's unless given: a MoE
    model's dense prefix takes ``d_ff_dense``), as the JAX package's."""
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    out = {
        "ln": spec((d,), ("act_embed",), init="zeros"),
        "w_gate": spec((d, f), ("embed", "mlp")),
        "w_up": spec((d, f), ("embed", "mlp")),
        "w_down": spec((f, d), ("mlp", "embed")),
    }
    if cfg.attn_softcap > 0:
        out["post_ln"] = spec((d,), ("act_embed",), init="zeros")
    return out


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    out = swiglu(rms_norm(x, p["ln"]), p["w_gate"], p["w_up"], p["w_down"])
    if "post_ln" in p:
        out = rms_norm(out, p["post_ln"])
    return x + out


# ---------------------------------------------------------------------------
# Routed MoE (sort-based capacity dispatch)
# ---------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """One MoE layer's specs by name, as the JAX package's ``moe_specs``:
    norm, router, the experts' SwiGLU weights (experts first) and, with
    ``num_shared``, the always-on shared expert's."""
    mo = cfg.moe
    assert mo is not None
    d, E, fe = cfg.d_model, mo.num_experts, mo.d_expert
    out = {
        "ln": spec((d,), ("act_embed",), init="zeros"),
        "router": spec((d, E), ("embed", None)),
        "w_gate": spec((E, d, fe), ("experts", "embed", "expert_mlp")),
        "w_up": spec((E, d, fe), ("experts", "embed", "expert_mlp")),
        "w_down": spec((E, fe, d), ("experts", "expert_mlp", "embed")),
    }
    if mo.num_shared:
        fs = fe * mo.num_shared
        out["shared_gate"] = spec((d, fs), ("embed", "mlp"))
        out["shared_up"] = spec((d, fs), ("embed", "mlp"))
        out["shared_down"] = spec((fs, d), ("mlp", "embed"))
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


def dispatch(
    top_e: torch.Tensor, num_experts: int, cap: int, experts: Optional[torch.Tensor] = None,
    before: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, dest)`` of the ``T * k`` (token, slot) pairs of ``top_e``
    (pair ``i`` is token ``i // k``'s slot ``i % k``): ``order`` sorts them
    by expert, stably (as ``jnp.argsort``: which pairs overflow depends on
    it), and ``dest[j]`` is sorted pair ``j``'s row of the ``[E * cap]``
    expert buffer, its expert's first free row, or the waste row ``E * cap``
    once the expert holds ``cap`` pairs (dropped). ``experts``, a 1-D
    tensor of ``count`` expert ids, keeps a buffer of those experts only,
    in that order (``[count * cap]``, a rank's local experts): every other
    expert's pairs go to its waste row ``count * cap``. ``before`` ``[E]``
    counts the pairs of each expert that come ahead of these in a stable
    sort of a whole batch of which ``top_e`` is one block (the placed
    dispatch's other ranks' blocks before this one): each pair's place in
    its expert's group starts past them."""
    e_flat = top_e.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    ar = torch.arange(e_flat.numel(), device=e_flat.device)
    group_start = torch.searchsorted(e_sorted, torch.arange(num_experts, device=e_flat.device, dtype=e_sorted.dtype))
    pos_in_e = ar - group_start[e_sorted]  # each pair's place in its expert's group
    if before is not None:
        pos_in_e = pos_in_e + before.to(pos_in_e.dtype)[e_sorted]
    if experts is None:
        return order, torch.where(pos_in_e < cap, e_sorted * cap + pos_in_e, num_experts * cap)
    count = experts.numel()
    local_of = torch.full((num_experts,), -1, dtype=e_sorted.dtype, device=e_sorted.device)
    local_of[experts.to(e_sorted.device)] = torch.arange(count, dtype=e_sorted.dtype, device=e_sorted.device)
    slot = local_of[e_sorted]
    keep = (slot >= 0) & (pos_in_e < cap)
    return order, torch.where(keep, slot * cap + pos_in_e, count * cap)


class DroppedPairs:
    """The (token, slot) pairs ``moe_apply`` routed and those it dropped
    over capacity, summed over its calls. ``routed`` is a host integer;
    the dropped count is summed on each device without a host sync (so
    counting costs a decode step nothing), and ``dropped`` synchronizes."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def add(self, routed: int, dropped: torch.Tensor, *, placed: bool = False) -> None:
        """One call's pairs; ``placed``: a call of the placed dispatch
        (:func:`_moe_placed`), counted in ``placed_calls`` too."""
        with self._lock:
            self.calls += 1
            self.placed_calls += placed
            self.routed += routed
            key = dropped.device
            self._dropped[key] = self._dropped[key] + dropped if key in self._dropped else dropped

    def reset(self) -> None:
        with self._lock:
            self.calls, self.placed_calls, self.routed, self._dropped = 0, 0, 0, {}

    @property
    def dropped(self) -> int:
        with self._lock:
            return sum(int(t) for t in self._dropped.values())


#: every ``moe_apply`` call's routed and dropped pairs
DROPPED = DroppedPairs()


def _to_buffer(flat: torch.Tensor, order: torch.Tensor, dest: torch.Tensor, rows: int, k: int) -> torch.Tensor:
    """The dispatched pairs' tokens placed into ``[rows, D]`` (``dest`` of
    :func:`dispatch`, the waste row dropped)."""
    return flat.new_zeros(rows + 1, flat.shape[1]).index_put((dest,), flat[order // k])[:rows]


def _expert_swiglu(p: Params, grouped: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU (``p``'s ``[n_experts, ...]`` weights) over every
    row of every expert of ``grouped`` ``[n_experts, cap, D]``: three batched
    products."""
    g = torch.bmm(grouped, p["w_gate"])
    u = torch.bmm(grouped, p["w_up"])
    return torch.bmm(F.silu(g) * u, p["w_down"])


def _from_buffer(y_rows: torch.Tensor, top_p: torch.Tensor, order: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Each pair's output row of ``y_rows`` ``[rows, D]`` (the waste row
    zero) in pair order (token * k + slot), weighted by its probability
    and summed over the slots in order: ``[T, D]`` in f32."""
    (t, k), d = top_p.shape, y_rows.shape[1]
    y_flat = torch.cat([y_rows, y_rows.new_zeros(1, d)])
    dest_by_pair = torch.empty_like(dest).scatter_(0, order, dest)
    contrib = (y_flat[dest_by_pair] * top_p.reshape(-1, 1).to(y_rows.dtype)).view(t, k, d).float()
    combined = contrib[:, 0]
    for j in range(1, k):
        combined = combined + contrib[:, j]
    return combined


def _experts_combined(p: Params, flat: torch.Tensor, top_p: torch.Tensor, order: torch.Tensor, dest: torch.Tensor,
                      cap: int) -> torch.Tensor:
    """The dispatched pairs through the experts' SwiGLU (``p``'s ``[n_experts,
    ...]`` weights), combined into ``[T, D]`` in f32:
    the pairs placed into an ``[n_experts, cap, D]`` buffer (``dest`` of
    :func:`dispatch`, the waste row dropped), three batched products over
    all its rows, and each pair's output in pair order (token * k + slot),
    weighted by its probability and summed over the slots in order."""
    n_experts, d = p["w_gate"].shape[0], flat.shape[1]
    rows = n_experts * cap
    y = _expert_swiglu(p, _to_buffer(flat, order, dest, rows, top_p.shape[1]).view(n_experts, cap, d))
    return _from_buffer(y.reshape(rows, d), top_p, order, dest)


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
    expert order).

    On DTensors the dispatch is placed (:func:`_moe_placed`): each rank
    dispatches its own tokens, and the tokens are never gathered whole."""
    mo = cfg.moe
    assert mo is not None
    b, s, d = x.shape
    t, k, E = b * s, mo.top_k, mo.num_experts
    cap = capacity(cfg, t)

    h = rms_norm(x, p["ln"])
    if optim.is_dtensor(h):
        out = _moe_placed(cfg, p, h, cap)
    else:
        flat = h.reshape(t, d)
        top_p, top_e = route(cfg, p, flat)
        order, dest = dispatch(top_e, E, cap)
        DROPPED.add(t * k, (dest == E * cap).sum())
        out = _experts_combined(p, flat, top_p, order, dest, cap).to(x.dtype).view(b, s, d)

    if mo.num_shared:  # on [B, S, D], not the flat tokens: DTensor may split those over more ranks than B divides
        out = out + swiglu(h, p["shared_gate"], p["shared_up"], p["shared_down"])
    return x + out


def _all_reduce(x: torch.Tensor, groups: tuple) -> torch.Tensor:
    """A copy of ``x`` summed over each of ``groups`` (``all_reduce``)."""
    import torch.distributed as dist

    x = x.clone()
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _BatchSum(torch.autograd.Function):
    """The sum over ``groups`` (the batch dimensions') of each rank's
    partial buffer, which every rank then holds alike and uses for its own
    part of the loss: the backward sums the ranks' cotangents the same
    way."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, groups: tuple) -> torch.Tensor:
        ctx.groups = groups
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _all_reduce(grad, ctx.groups), None


def _scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``'s ranks of each rank's ``[n * m, ...]`` rows,
    each rank keeping its own ``m`` (``reduce_scatter``: chunk ``i`` to
    rank ``i``)."""
    import torch.distributed as dist

    out = x.new_empty(x.shape[0] // dist.get_world_size(group), *x.shape[1:])
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank of ``group``'s ``[m, ...]`` rows in rank order
    (``all_gather``)."""
    import torch.distributed as dist

    out = x.new_empty(x.shape[0] * dist.get_world_size(group), *x.shape[1:])
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _ScatterRows(torch.autograd.Function):
    """:func:`_scatter_rows`; its backward gathers the cotangents' blocks
    back."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _scatter_rows(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _gather_rows(grad, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """:func:`_gather_rows`; its backward sums the cotangents over the
    group and keeps each rank's own block."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _scatter_rows(grad, ctx.group), None


def _moe_placed(cfg: ModelConfig, p: Params, h: torch.Tensor, cap: int) -> torch.Tensor:
    """The routed part of :func:`moe_apply` on DTensors (H3 off): ``[B, S,
    D]`` placed as ``h`` (the normed tokens) is placed by the batch alone,
    the JAX package's global capacity ``cap`` kept and the same pairs
    dropped, and no rank ever holding the tokens, the routing indices or
    the pairs' rows of the whole batch.

    Each rank routes the tokens of its own block of the batch (the batch
    over the flags' batch axes where it divides them, as
    :func:`batch_placed`), sorts its own pairs stably by expert and counts
    them an expert; one all-gather of those ``[E]`` counts over the batch
    dimensions gives each rank the pairs of each expert on the ranks
    before it, in the order of the global token index, so each pair's
    place in its expert's group is the one the JAX package's global stable
    ``argsort`` gives it (:func:`dispatch`'s ``before``), and the dropped
    pairs (``DROPPED``) are counted from the counts' totals, as one device
    counts them. Each rank writes the rows of its own kept pairs into the
    buffer of the experts placed where its weights' blocks lie (the
    experts the weights split over the mesh dimensions that do not carry
    the batch: this rank's block of them), and one reduction over the batch
    dimensions assembles it where those blocks need it: a sum over those
    that do not split the experts (``all_reduce``) and, over those that do
    (``SERVE_RULES``' experts over ``("data", "model")``), each rank's own
    experts' rows (``reduce_scatter``, their outputs gathered back after
    the products). The expert weights are gathered to their experts'
    blocks (a training step's FSDP gather), their hidden width split over
    the batch dimensions the buffer was summed over where it divides them,
    so no two ranks compute the same product: each rank's partial outputs
    are summed over those dimensions (``all_reduce``) before each rank
    reads its own pairs' rows. Each rank combines the rows of its own pairs
    only, a partial sum over the dimensions that split the experts beside
    the batch (the model axis), summed (``all_reduce`` of ``[tokens of the
    block, D]``).

    The backward moves the same kinds of bytes: the sums' cotangents summed
    over the same dimensions, the combine's over the model axis, the
    weights' gradients reduced to their placements. On a mesh of one device
    this is :func:`moe_apply`'s plain path, bit for bit."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.sharding.rules import placements_for

    mo = cfg.moe
    E, k = mo.num_experts, mo.top_k
    mesh = h.device_mesh
    nd = mesh.ndim
    b, s, d = h.shape
    xpl = placements_for(optim.attn_spec((b, s, d), mesh, heads=False), mesh)
    bdims = [i for i, q in enumerate(xpl) if q.is_shard()]
    w = p["w_gate"]
    edims = [i for i, q in enumerate(w.placements) if q.is_shard(0)] if optim.is_dtensor(w) else []
    split_b = [i for i in edims if i in bdims]  # the batch dimensions that split the experts too
    split_o = [i for i in edims if i not in bdims]  # the others that split them (the model axis)
    sums = [i for i in bdims if i not in edims]  # the batch dimensions the buffer is summed over

    def local(t: torch.Tensor, placements, grad=None) -> torch.Tensor:
        """This rank's block of ``t`` placed by ``placements`` (``grad``: the
        placements of its gradient, the block's own by default)."""
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * nd, run_check=False)
        return t.redistribute(mesh, placements).to_local(grad_placements=grad)

    whole = [Replicate()] * nd
    partial = tuple(Partial() if i in bdims else Replicate() for i in range(nd))  # read on a batch block
    h_loc = local(h, xpl)
    bl, t = h_loc.shape[0], h_loc.shape[0] * s
    copies = tuple(mesh.get_group(i) for i in split_o)
    groups = tuple(mesh.get_group(i) for i in sums)
    flat = h_loc.reshape(t, d)
    routed = _ModelCopy.apply(flat, copies) if copies else flat
    router = local(p["router"], whole, partial)
    top_p, top_e = route(cfg, {"router": _ModelCopy.apply(router, copies) if copies else router}, routed)

    # the pairs of each expert on every rank of the batch dimensions, in the global token order
    e_flat = top_e.reshape(-1)
    counts = e_flat.new_zeros(E).index_add_(0, e_flat, torch.ones_like(e_flat))
    ranks = math.prod(mesh.size(i) for i in bdims)
    pl = [Shard(0) if i in bdims else Replicate() for i in range(nd)]
    every = DTensor.from_local(counts[None], mesh, pl, run_check=False, shape=(ranks, E), stride=(E, 1)).full_tensor()
    me = 0
    for i in bdims:  # this rank's place in the batch, the outer mesh dimension first
        me = me * mesh.size(i) + mesh.get_local_rank(i)
    before = every[:me].sum(0)
    DROPPED.add(b * s * k, (every.sum(0) - cap).clamp_min(0).sum(), placed=True)

    # the experts whose rows this rank writes: the weights' expert blocks at its own place on split_o
    ways = [mesh.size(i) for i in edims]
    grid = torch.arange(E).view(*ways, E // math.prod(ways))
    ids = grid[tuple(mesh.get_local_rank(i) if i in split_o else slice(None) for i in edims)].reshape(-1)
    order, dest = dispatch(top_e, E, cap, experts=ids, before=before)
    rows = _to_buffer(routed, order, dest, ids.numel() * cap, k)
    for i in split_b:  # the outer mesh dimension first: its rank i keeps the i-th chunk
        rows = _ScatterRows.apply(rows, mesh.get_group(i))
    if sums:
        rows = _BatchSum.apply(rows, groups)

    # the experts' hidden width split over the dimensions the buffer was summed over, where it divides them:
    # each rank its slice of every row (else each computes every row, and reads its own pairs' only)
    width = sums if p["w_gate"].shape[2] % math.prod(mesh.size(i) for i in sums) == 0 else []

    def expert(n: str, hidden: int) -> torch.Tensor:
        """This rank's block of the expert weight ``n`` (its hidden width on
        dimension ``hidden``), gathered from its FSDP shards."""
        pl = [Shard(0) if i in edims else Shard(hidden) if i in width else Replicate() for i in range(nd)]
        return local(p[n], pl, [Partial() if i in sums and i not in width else q for i, q in enumerate(pl)])

    lw = {"w_gate": expert("w_gate", 2), "w_up": expert("w_up", 2), "w_down": expert("w_down", 1)}
    y = _expert_swiglu(lw, rows.view(-1, cap, d)).reshape(-1, d)
    if width:
        y = _BatchSum.apply(y, groups)
    for i in reversed(split_b):
        y = _GatherRows.apply(y, mesh.get_group(i))
    combined = _from_buffer(y, top_p, order, dest)
    if copies:
        combined = _ModelSum.apply(combined, copies)
    out = combined.to(h_loc.dtype).view(bl, s, d)
    return DTensor.from_local(out, mesh, xpl, run_check=False, shape=h.shape, stride=h.stride())


class _ModelSum(torch.autograd.Function):
    """The sum over the model axis's ranks (``all_reduce`` over each of a
    tuple of groups) of each rank's partial result. Its backward is the
    identity: the sum is
    replicated, so its cotangent is every rank's, and each partial term's
    is that cotangent (``torch.distributed.nn.functional.all_reduce``
    reduces the cotangent again, making it ``tp`` times too large)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, groups: tuple) -> torch.Tensor:
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _ModelCopy(torch.autograd.Function):
    """The identity on a tensor that every model rank holds alike and each
    uses for its own partial result; its backward sums the ranks' partial
    cotangents over each of a tuple of groups (Megatron's copy into the
    model-parallel region)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, groups: tuple) -> torch.Tensor:
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _all_reduce(grad, ctx.groups), None


def moe_apply_shardmap(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """H3 (:mod:`repro_torch.models.optim`): expert parallelism over
    ``optim.FLAGS.mesh``, the JAX package's ``moe_apply_shardmap``.

    Each rank dispatches only its LOCAL tokens (x's batch sharded over the
    flags' batch axes), runs only its ``E / tp`` LOCAL experts (the model
    rank's contiguous block; where the rules split the experts over other
    mesh axes too, as ``SERVE_RULES`` do, the strided set that one
    all-gather over those axes delivers), sends every other pair to its
    drop row, combines in f32
    and sums once over the model axis's process group (``all_reduce``). The
    shared expert is added after the sum. Falls back to :func:`moe_apply`
    on the whole tensors where the JAX code does (``tp <= 1``, ``E % tp``, a
    batch that does not divide, no batch axis of more than one device).

    ``x`` and ``p``'s tensors are DTensors on the mesh, placed as the rules
    place them (each is redistributed to what its part needs), or plain
    tensors, taken as replicated. The result has x's placements (a plain x
    gives a plain, whole result; a partial x, a replicated one).

    Differentiable. The redistributions in and out are DTensor's, with
    their own backwards. Inside, the routed part's input is the normed
    tokens through :class:`_ModelCopy` (each model rank's cotangent covers
    its own experts' pairs; the copy's backward sums them) and its output
    the sum :class:`_ModelSum` (identity backward); the router's, the
    norm's and the shared expert's local gradients are declared partial
    over the batch axes (each rank saw its own tokens), the experts' also
    sharded over the model axis, so DTensor sums them where their
    parameters are placed. The fallback is :func:`moe_apply`'s autograd on
    tensors replicated on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.sharding.rules import mesh_axis_sizes, placements_for

    f = optim.FLAGS
    mo = cfg.moe
    mesh = f.mesh
    assert mo is not None and mesh is not None
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get(f.model_axis, 1)
    bdims = tuple(a for a in f.batch_axes if sizes.get(a, 1) > 1)
    E = mo.num_experts

    def local(t: torch.Tensor, spec, grad=None) -> torch.Tensor:
        """This rank's block of ``t`` placed by ``spec`` (``grad``: the
        placements of its gradient, the block's own by default)."""
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, placements_for(spec, mesh)).to_local(grad_placements=grad)

    def like_x(out: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block ``out`` (placed by ``spec``) as x is placed
        (where x is a partial sum, replicated)."""
        dt = DTensor.from_local(out, mesh, placements_for(spec, mesh), run_check=False)
        if not isinstance(x, DTensor):
            return dt.full_tensor()
        return dt.redistribute(mesh, [Replicate() if q.is_partial() else q for q in x.placements])

    whole = (None, None, None)
    if tp <= 1 or E % tp or x.shape[0] % math.prod(sizes[a] for a in bdims) or not bdims:
        full = {n: local(t, (None,) * t.ndim) for n, t in p.items()}
        return like_x(moe_apply(cfg, full, local(x, whole)), whole)
    e_loc = E // tp
    xspec = (bdims if len(bdims) > 1 else bdims[0], None, None)
    names = tuple(mesh.mesh_dim_names)

    def grad_of(n: str) -> tuple:
        """A parameter's local gradient: partial over the batch axes, and
        the experts' sharded over the model axis as they are."""
        spec = placements_for((f.model_axis, None, None) if n in experts else (None,) * p[n].ndim, mesh)
        return tuple(Partial() if a in bdims else q for a, q in zip(names, spec))

    experts = ("w_gate", "w_up", "w_down")
    mi, m = names.index(f.model_axis), mesh.get_local_rank(f.model_axis)
    w = p["w_gate"]
    split = [i for i, q in enumerate(w.placements) if q.is_shard(0)] if isinstance(w, DTensor) else []
    if mi in split and len(split) > 1:  # the experts over the model axis and others: a strided set
        ways = [mesh.size(i) for i in split]
        ids = torch.arange(E).view(*ways, E // math.prod(ways)).select(split.index(mi), m).reshape(-1)
    else:
        ids, split = torch.arange(m * e_loc, (m + 1) * e_loc), []

    def local_experts(n: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's experts ``ids`` of the expert weight ``n``, ``t``
        ``[E, ...]``. Where the rules split the experts over the model axis
        and other mesh axes too (``SERVE_RULES``' ``("data", "model")``:
        expert ``e`` on data rank ``e // (E / dp)`` and model rank ``e // c
        % tp``, ``c`` experts a device), the experts are viewed ``[n_1, ..,
        n_k, c, ...]``, one view dimension a splitting mesh axis, and
        gathered over every mesh axis but the model axis: this model rank's
        experts on each of them, one all-gather, never the layer's ``E``.
        Else the model rank's contiguous block of ``E / tp``."""
        if not split:
            return local(t, (f.model_axis, None, None), grad_of(n))
        k, block = len(split), t.to_local()
        shape = (*ways, E // math.prod(ways), *t.shape[1:])
        viewed = [Shard(split.index(i)) if i in split else Shard(q.dim + k) if q.is_shard() else q
                  for i, q in enumerate(t.placements)]
        dt = DTensor.from_local(block.view(*([1] * k), *block.shape), mesh, viewed, run_check=False, shape=shape,
                                stride=tuple(math.prod(shape[j + 1:]) for j in range(len(shape))))
        target = [Shard(split.index(mi)) if i == mi else Replicate() for i in range(mesh.ndim)]
        grad = [Partial() if a in bdims else q for a, q in zip(names, target)]
        return dt.redistribute(mesh, target).to_local(grad_placements=grad).reshape(-1, *t.shape[1:])

    lp = {n: local_experts(n, t) if n in experts else local(t, (None,) * t.ndim, grad_of(n)) for n, t in p.items()}
    x_loc = local(x, xspec)

    b, s, d = x_loc.shape
    t = b * s
    group = mesh.get_group(f.model_axis)
    flat = rms_norm(x_loc, lp["ln"]).reshape(t, d)
    routed = _ModelCopy.apply(flat, (group,))
    top_p, top_e = route(cfg, {"router": _ModelCopy.apply(lp["router"], (group,))}, routed)
    cap = capacity(cfg, t)
    order, dest = dispatch(top_e, E, cap, experts=ids)
    combined = _experts_combined(lp, routed, top_p, order, dest, cap)
    out = _ModelSum.apply(combined, (group,)).to(x_loc.dtype)
    if mo.num_shared:
        out = out + swiglu(flat, lp["shared_gate"], lp["shared_up"], lp["shared_down"])
    return like_x(x_loc + out.view(b, s, d), xspec)


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
