"""The decoder LM (forward, prefill and one-token decode) and the encoder
LM (forward).

The port's copy of the JAX package's ``DecoderLM`` (its decoder branches)
(``models/lm.py``). Parameters are the flat dict a TensorHub replica
registers: the names of :func:`repro_torch.models.params.decoder_shapes`,
with the layer axis stacked first. Layer ``i`` reads the views
``params["layers/attn/wq"][i]`` and so on, so a replica's registered
tensors *are* the model and serving makes no copy of them; an ``update``
that writes the buffers in place is seen by the next batch.

``forward`` is differentiable with respect to the parameter dict (the
training step's loss): it takes each stacked tensor apart once with
``unbind(0)``, whose backward is a single ``stack``, where indexing
layer by layer would give every layer's backward a zero tensor of the
whole stack.

gemma2's extras are here: even layers attend through a sliding window and
odd layers globally (``_layer_windows``), the attention scores and the
logits are softcapped, each block's output is normed again (``post_ln``),
and the embedding is tied (scaled by ``sqrt(d_model)`` on the way in, its
transpose the head).

A config with ``moe`` (dbrx) runs the routed-expert FFN
(:func:`repro_torch.models.blocks.moe_apply`, with the always-on shared
expert where ``moe.num_shared`` asks for one) in its stacked layers, and
its first ``moe.first_dense`` layers as a dense ``prefix``
(``params["prefix/<i>/..."]``, unstacked, a dense FFN of
``moe.d_ff_dense``) before them, as the JAX package's ``prefix`` list
(deepseek-v3's).

A config with ``mla`` (deepseek-v3) attends through multi-head latent
attention (:func:`repro_torch.models.blocks.mla_apply`): the expanded
form in ``forward`` and ``prefill`` (through ``attention``), the absorbed
form in ``decode`` (through ``latent_attention``, the ``mla_decode``
kernel's wrapper by default) against a cache of one latent row and one
rope key a slot, ``{"ckv": [.., B, Smax, R], "krope": [.., B, Smax, rd]}``
with the sequence on axis 1, as the JAX package's ``_attn_cache_spec``.

A VLM config (internvl2-2b) takes precomputed patch embeddings,
``batch["patches"]`` ``[B, P, d_model]``, cast to the activations' dtype
and placed before the token embeddings in ``forward`` and ``prefill`` (the
JAX package's ``_inputs``): positions run over patches and tokens, the
logits cover both, and ``decode`` continues from ``P + prompt_len``.

:class:`EncoderLM` is the JAX package's encoder (hubert-xlarge): frames
projected into the model, every layer's attention bidirectional, a GELU
MLP with biases.

:class:`HybridLM` is the JAX package's hybrid (zamba2-2.7b): groups of
Mamba2 (SSD) blocks (:mod:`repro_torch.models.ssd`), each group followed
by one shared attention block and MLP whose weights every call reuses;
its decode also runs over a ring-buffer window cache (``ring=True``,
:func:`_ring_slot`).

:class:`XLSTMLM` is the JAX package's xLSTM (xlstm-350m): pairs of
``slstm_every - 1`` mLSTM blocks and one sLSTM block
(:mod:`repro_torch.models.xlstm_blocks`), with a recurrent cache whose size
does not depend on the sequence's length.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import VLM, ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.models import blocks, optim, ssd, xlstm_blocks
from repro_torch.models.layers import apply_rope, gelu_mlp, rms_norm, softcap
from repro_torch.models.params import ParamSpec, map_specs, spec, stack_layers

Params = Mapping[str, torch.Tensor]
Cache = Dict[str, Dict[str, torch.Tensor]]

_ATTN = ("ln", "wq", "wk", "wv", "wo")
_FFN = ("ln", "w_gate", "w_up", "w_down")
_ENC_FFN = ("ln", "w_up", "b_up", "w_down", "b_down")


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Each layer's sliding window (0 = global attention): gemma2's even
    layers are local, its odd layers global, as the JAX package's
    ``_layer_windows`` (whose ``long_mode`` no caller passes: the hybrid
    family's window is its ring cache's size, :class:`HybridLM`)."""
    if cfg.alt_local_global:
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(cfg.num_layers)]
    return [0] * cfg.num_layers


def on_mesh(params: Params) -> bool:
    """Whether ``params`` are DTensors on a ``DeviceMesh`` (the sharded
    train step's, :func:`repro_torch.sharding.place_tree`)."""
    return any(optim.is_dtensor(t) for t in params.values())


#: how deep this process is in :func:`mesh_scope`s
_MESH_SCOPES = 0


@contextlib.contextmanager
def mesh_scope(params: Params):
    """The context a forward or a loss over DTensor parameters runs in:
    DTensor's ``implicit_replication``, under which the plain tensors that
    meet them (the tokens, positions and rope tables, a window's mask, the
    softcaps' scalars, the labels, and what autograd saved of them) are
    taken as replicated on their mesh, as GSPMD takes an unconstrained
    constant. Nothing for plain parameters. It nests (the step's scope
    holds the model's): ``implicit_replication`` itself switches off at
    the end of any scope, so only the outermost one enters it."""
    global _MESH_SCOPES
    if _MESH_SCOPES or not on_mesh(params):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _MESH_SCOPES += 1
    try:
        with implicit_replication():
            yield
    finally:
        _MESH_SCOPES -= 1


def refuse_mesh(cfg: ModelConfig, params: Params, what: str) -> None:
    """Raise ``NotImplementedError`` naming ``cfg``'s family where DTensor
    parameters reach a model whose sharded path is not ported (``what``)."""
    if on_mesh(params):
        raise NotImplementedError(f"{cfg.name} ({cfg.family} family, {what}): the sharded serving and train steps "
                                  f"(DTensor parameters on a DeviceMesh) are not ported for it")


class _EmbedRows(torch.autograd.Function):
    """``table[tokens]`` of a table placed on a mesh (a DTensor), with the
    gradient a data-parallel step takes: the cotangent placed as the
    tokens are (its partial sums over the model axis added), each rank's
    rows scatter-added into a whole table of its own, that table's sum
    over the ranks that held other tokens (partial over the tokens' mesh
    dimensions) reduced to the table's placements. DTensor's own backward
    of the lookup (an ``index_put`` of the partial cotangent) is refused by
    some PyTorch releases' sharding propagation."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(tokens)
        ctx.table = (table.device_mesh, tuple(table.placements), tuple(table.shape), table.dtype)
        return table[tokens]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        (tokens,) = ctx.saved_tensors
        mesh, placements, shape, dtype = ctx.table
        if optim.is_dtensor(tokens):
            tok_pl = tuple(tokens.placements)
            tokens = tokens.to_local()
        else:
            tok_pl = (Replicate(),) * mesh.ndim
        local = grad.redistribute(mesh, tok_pl).to_local() if optim.is_dtensor(grad) else grad
        rows = local.new_zeros(shape, dtype=dtype).index_put_((tokens,), local.to(dtype), accumulate=True)
        partial = [Partial() if p.is_shard() else Replicate() for p in tok_pl]
        whole = DTensor.from_local(rows, mesh, partial, run_check=False)
        return whole.redistribute(mesh, placements), None


def mesh_of(params: Params):
    """The ``DeviceMesh`` of DTensor parameters, or None for plain ones."""
    for t in params.values():
        if optim.is_dtensor(t):
            return t.device_mesh
    return None


class DecoderLM:
    """Causal decoder: (dense GQA | MLA) attention x (SwiGLU | routed MoE) FFN.

    ``attention`` is the attention function every layer calls, the flash
    kernel's wrapper by default; a reference computation passes
    :func:`repro_torch.kernels.flash_attention.attention_plain`.
    ``latent_attention`` is the MLA decode's (the ``mla_decode`` kernel's
    wrapper by default; a reference passes
    :func:`repro_torch.kernels.mla_decode.mla_decode_plain`)."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        attention: Callable[..., torch.Tensor] = flash_attention,
        latent_attention: Callable[..., torch.Tensor] = mla_decode,
    ):
        self.cfg = cfg
        self.attention = attention
        self.latent_attention = latent_attention
        self.is_moe = cfg.moe is not None
        self.is_mla = cfg.mla is not None
        self.n_prefix = cfg.moe.first_dense if self.is_moe else 0
        self.n_scan = cfg.num_layers - self.n_prefix
        #: the stacked layers' windows (the prefix layers attend globally)
        self.windows = _layer_windows(cfg)[self.n_prefix :]
        post = ("post_ln",) if cfg.attn_softcap > 0 else ()
        self._attn_names = tuple(blocks.mla_specs(cfg)) if self.is_mla else _ATTN + post
        self._dense_names = _FFN + post
        if self.is_moe:
            self._ffn_names = tuple(blocks.moe_specs(cfg))
        else:
            self._ffn_names = self._dense_names

    # -- embedding / head ------------------------------------------------------

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        table = params["embed"]
        x = _EmbedRows.apply(table, tokens) if optim.is_dtensor(table) else table[tokens]
        if self.cfg.tie_embeddings:  # gemma2 normalizes the embedding scale
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=torch.float32).to(x.dtype)
        return x

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_ln"])
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        return softcap((x @ w).float(), self.cfg.logit_softcap)

    def _inputs(self, params: Params, batch: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The embedded inputs ``[B, S, d_model]`` and their positions: the
        tokens' embeddings, after a VLM's patches (``[B, P, d_model]``,
        cast to the embeddings' dtype)."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.family == VLM:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x, torch.arange(x.shape[1], device=x.device)

    def _layer(self, params: Params, i: int) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        attn = {n: params[f"layers/attn/{n}"][i] for n in self._attn_names}
        ffn = {n: params[f"layers/ffn/{n}"][i] for n in self._ffn_names}
        return attn, ffn

    def _prefix_layer(self, params: Params, i: int) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        attn = {n: params[f"prefix/{i}/attn/{n}"] for n in self._attn_names}
        ffn = {n: params[f"prefix/{i}/ffn/{n}"] for n in self._dense_names}
        return attn, ffn

    def _block(self, layer, x, positions, *, window=0, dense=True, cache=None, cache_len=None):
        attn, ffn = layer
        if self.is_mla:
            x, kv = blocks.mla_apply(
                self.cfg, attn, x, positions=positions, attention=self.attention,
                latent_attention=self.latent_attention, cache=cache, cache_len=cache_len,
            )
        else:
            x, kv = blocks.attn_apply(
                self.cfg, attn, x, positions=positions, attention=self.attention, window=window,
                cache=cache, cache_len=cache_len,
            )
        if dense:
            return blocks.mlp_apply(ffn, x), kv
        if optim.FLAGS.shardmap_moe and optim.FLAGS.mesh is not None:  # H3
            return blocks.moe_apply_shardmap(self.cfg, ffn, x), kv
        return blocks.moe_apply(self.cfg, ffn, x), kv

    def _run(self, params: Params, x, positions, *, layers=None, slots=None, cache_len=None):
        """Every layer in order, the dense prefix first. ``layers(i)`` gives
        stacked layer ``i``'s views where the caller took the stacks apart
        once. ``slots`` holds one cache a layer (:meth:`_slots`): in
        decode (``cache_len`` given) each layer attends over its slot and
        writes it in place, in prefill each layer's fresh entries (K/V, or
        MLA's latent and rope key) fill the first positions of its slot,
        along each entry's sequence axis (:attr:`seq_axis`)."""
        plan = [(self._prefix_layer(params, i), 0, True) for i in range(self.n_prefix)]
        plan += [(layers(i) if layers is not None else self._layer(params, i), self.windows[i], not self.is_moe)
                 for i in range(self.n_scan)]
        for j, (layer, window, dense) in enumerate(plan):
            cache = slots[j] if cache_len is not None else None
            x, kv = self._block(layer, x, positions, window=window, dense=dense, cache=cache, cache_len=cache_len)
            if slots is not None and cache_len is None:
                for n, t in kv.items():
                    blocks.write_at(slots[j][n], t, self.seq_axis, 0)
        return x

    @property
    def seq_axis(self) -> int:
        """The sequence axis of a layer's cache entries: 1 of MLA's ``[B,
        S, R]``, 2 of the K/V's ``[B, Hkv, S, hd]``."""
        return 1 if self.is_mla else 2

    def _slots(self, cache: Cache) -> List[Dict[str, torch.Tensor]]:
        """Each layer's entries of ``cache``, in layer order (views of the
        stacked layers' caches)."""
        stacked = [{n: t[i] for n, t in cache["layers"].items()} for i in range(self.n_scan)]
        return [*cache.get("prefix", []), *stacked]

    # -- forward (teacher-forced) ----------------------------------------------

    def forward(self, params: Params, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` (f32) of a token batch ``{"tokens": [B, S]}``
        (a VLM's also ``"patches": [B, P, d_model]``, and its logits ``[B, P
        + S, vocab]``).

        DTensor parameters (the sharded train step's) run under
        :func:`mesh_scope`, the attention on each rank's local block (MLA's
        on its block of the query heads, ``blocks._HeadBlocks``)."""
        with mesh_scope(params):
            x, positions = self._inputs(params, batch)
            attn = {n: params[f"layers/attn/{n}"].unbind(0) for n in self._attn_names}
            ffn = {n: params[f"layers/ffn/{n}"].unbind(0) for n in self._ffn_names}

            def layers(i):
                return {n: t[i] for n, t in attn.items()}, {n: t[i] for n, t in ffn.items()}

            return self._head(params, self._run(params, x, positions, layers=layers))

    # -- caches ------------------------------------------------------------------

    def _attn_cache_spec(self, b: int, m: int) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        if self.is_mla:
            ml = cfg.mla
            return {
                "ckv": spec((b, m, ml.kv_lora_rank), ("batch", "seq", "kv_lora")),
                "krope": spec((b, m, ml.qk_rope_head_dim), ("batch", "seq", None)),
            }
        kv = spec((b, cfg.num_kv_heads, m, cfg.resolved_head_dim), ("batch", "kv_heads", "seq", "head_dim"))
        return {"k": kv, "v": kv}

    def cache_specs(self, batch_size: int, max_len: int, *, ring: bool = False) -> Dict[str, object]:
        """The JAX ``cache_specs``: ``{"layers": {"k", "v"}}`` stacked
        ``[stacked layers, B, Hkv, m, hd]`` (MLA: ``{"ckv", "krope"}``
        stacked ``[stacked layers, B, m, R]`` and ``[.., rd]``), and with a
        dense prefix ``"prefix"``, a list of one such dict a layer; ``m`` is
        ``min(max_len, sliding_window)`` with ``ring``, else ``max_len``."""
        m = min(max_len, self.cfg.sliding_window) if ring and self.cfg.sliding_window else max_len
        tree: Dict[str, object] = {"layers": stack_layers(self._attn_cache_spec(batch_size, m), self.n_scan)}
        if self.n_prefix:
            tree["prefix"] = [self._attn_cache_spec(batch_size, m) for _ in range(self.n_prefix)]
        return tree

    def init_cache(self, batch_size: int, max_len: int, dtype: torch.dtype, device, *, mesh=None,
                   like: Optional[torch.Tensor] = None) -> Cache:
        """Zeroed caches of :meth:`cache_specs` in ``dtype``. With a
        ``DeviceMesh`` ``mesh``, DTensors placed by the serve rules
        (``rules_for("decode", global_batch=batch_size)``), each rank
        zeroing its own block (:func:`repro_torch.sharding.place_new`):
        no rank builds a whole cache. The blocks are ``like.new_zeros`` where
        ``like`` is given (a prefill's local activations: fake in a dry run's
        trace), else zeros on the mesh's device."""
        specs = self.cache_specs(batch_size, max_len)
        if mesh is None:
            return map_specs(lambda p: torch.zeros(p.shape, dtype=dtype, device=device), specs)
        from repro_torch.sharding import place_new, rules_for

        def zeros(shape):
            if like is not None:
                return like.new_zeros(shape, dtype=dtype)
            return torch.zeros(shape, dtype=dtype, device=mesh.device_type)

        return place_new(specs, rules_for("decode", global_batch=batch_size), mesh, zeros)

    # -- prefill -------------------------------------------------------------------

    def prefill(
        self, params: Params, batch: Mapping[str, torch.Tensor], *, max_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Cache, int]:
        """Forward over the prompt that also fills a KV cache of ``max_len``
        slots (default: the prompt length); returns the logits of the last
        position only (``[B, 1, vocab]``: at vocab 128256 a 16 x 512
        batch's full logits would take 4.2 GB), the cache and its length.
        A VLM's patches come first: its cache length is ``P + prompt_len``,
        and ``max_len`` counts the patches.

        DTensor parameters (the sharded serving step's, placed by
        ``SERVE_RULES``) run under :func:`mesh_scope`; the cache is made
        placed by the serve rules (:meth:`init_cache` with the parameters'
        mesh) and each layer's K/V (MLA: latent and rope key) written into
        each rank's block of it."""
        with mesh_scope(params):
            x, positions = self._inputs(params, batch)
            b, s, _ = x.shape
            mesh = mesh_of(params)
            like = x.to_local() if mesh is not None else None
            cache = self.init_cache(b, max_len or s, x.dtype, x.device, mesh=mesh, like=like)
            x = self._run(params, x, positions, slots=self._slots(cache))
            return self._head(params, x[:, -1:]), cache, s

    # -- decode ------------------------------------------------------------------------

    def decode(
        self, params: Params, cache: Cache, tokens: torch.Tensor, cache_len: int
    ) -> Tuple[torch.Tensor, Cache]:
        """One step: ``tokens [B, 1]`` at position ``cache_len``. Writes
        the step's K/V (MLA: latent and rope key) into ``cache`` in place
        and returns it with the logits ``[B, 1, vocab]``. DTensor
        parameters and a cache placed as :meth:`init_cache` places it run
        under :func:`mesh_scope`: each layer writes its step's K/V into each
        rank's block of the cache and attends on its local blocks
        (``blocks._attend``; MLA's absorbed form on its block of the batch
        and the query heads against its batch block of the latent cache)."""
        with mesh_scope(params):
            x = self._embed(params, tokens)
            positions = cache_len + torch.arange(x.shape[1], device=x.device)
            x = self._run(params, x, positions, slots=self._slots(cache), cache_len=cache_len)
            return self._head(params, x), cache


class EncoderLM:
    """Bidirectional encoder over precomputed frame embeddings: the JAX
    package's ``EncoderLM`` (hubert-xlarge; the convolutional feature
    extractor is a stub there, ``batch["frames"]`` its output). No cache,
    no ``prefill`` and no ``decode``: an encoder has no decode path.
    DTensor parameters (the sharded train step's and the encode's) run
    under :func:`mesh_scope`, the attention on each rank's local block.

    ``attention`` is the attention every layer calls, with ``causal=False``
    (the flash kernel's wrapper by default; a reference computation passes
    :func:`repro_torch.kernels.flash_attention.attention_plain`). The
    parameters are the flat dict a replica registers
    (:func:`repro_torch.models.params.decoder_shapes` lists them)."""

    def __init__(self, cfg: ModelConfig, *, attention: Callable[..., torch.Tensor] = flash_attention):
        if not cfg.encoder_only:
            raise ValueError(f"{cfg.name}: EncoderLM takes an encoder-only config")
        self.cfg = cfg
        self.attention = attention

    def forward(self, params: Params, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` (f32) of ``{"frames": [B, S,
        frontend_dim]}``: the frames cast to ``frame_proj``'s dtype and
        projected, rope at positions ``0 .. S - 1`` in every layer's
        attention (``causal=False``), then ``h + gelu_mlp(rms_norm(h,
        ln), ...)``, the final norm and the head. Differentiable with
        respect to the parameter dict, each stack taken apart once with
        ``unbind(0)`` (as :meth:`DecoderLM.forward`)."""
        cfg = self.cfg
        with mesh_scope(params):
            w = params["frame_proj"]
            x = batch["frames"].to(w.dtype) @ w
            positions = torch.arange(x.shape[1], device=x.device)
            attn = {n: params[f"layers/attn/{n}"].unbind(0) for n in _ATTN}
            ffn = {n: params[f"layers/ffn/{n}"].unbind(0) for n in _ENC_FFN}
            for i in range(cfg.num_layers):
                x, _ = blocks.attn_apply(cfg, {n: t[i] for n, t in attn.items()}, x, positions=positions,
                                         attention=self.attention, causal=False)
                f = {n: t[i] for n, t in ffn.items()}
                # the MLP's input placed by the batch alone: left partial over the model axis, PyTorch 2.11's
                # DTensor asks the product for a batch-sharded block as a partial sum, which it cannot make
                h = blocks.batch_placed(rms_norm(x, f["ln"]))
                x = x + gelu_mlp(h, f["w_up"], f["b_up"], f["w_down"], f["b_down"])
            x = rms_norm(x, params["final_ln"])
            return (x @ params["head"]).float()


def _ring_slot(cache_len: int, window: int) -> int:
    """The ring cache's slot of position ``cache_len``."""
    return cache_len % window


def _ring_attention_step(
    attention: Callable[..., torch.Tensor],
    q: torch.Tensor,  # [B, Hq, 1, hd] (rope applied at cache_len)
    k_cache: torch.Tensor,  # [B, Hkv, W, hd] (rope applied at absolute positions)
    v_cache: torch.Tensor,
    cache_len: int,
    attn_softcap: float,
) -> torch.Tensor:
    """Attention over a ring-buffer window cache, the JAX package's
    ``_ring_attention_step`` through ``attention``: slot s holds position
    ``cache_len - ((cache_len - s) mod W)``, valid when it is >= 0, which
    are exactly the slots ``0 .. min(cache_len, W - 1)``; a softmax does not
    care about the order of its keys, so a call with ``causal=False`` and
    ``kv_len = min(cache_len + 1, W)`` computes what the JAX einsum does."""
    w = k_cache.shape[2]
    return attention(q, k_cache, v_cache, causal=False, softcap=attn_softcap, kv_len=min(cache_len + 1, w))


class HybridLM:
    """The hybrid LM (zamba2): ``num_layers`` Mamba2 blocks in groups of
    ``ssm.shared_block_every``, one shared attention block (global, causal)
    and SwiGLU MLP after each group, then the final norm and an untied
    head; the JAX package's ``HybridLM``.

    ``attention`` is the shared block's attention function, the flash
    kernel's wrapper by default; a reference computation passes
    :func:`repro_torch.kernels.flash_attention.attention_plain`. A query in
    the model's dtype against a cache of another (``init_cache``'s f32
    entries under bf16 weights) is cast to the cache's dtype for the call
    and the output back, which is what the JAX package's f32
    ``chunked_attention`` computes. Parameters are the flat dict a replica
    registers (:func:`repro_torch.models.params.decoder_shapes`): the
    stacked ``groups/...`` tensors are taken apart with views, so serving
    makes no copy of them."""

    def __init__(self, cfg: ModelConfig, *, attention: Callable[..., torch.Tensor] = flash_attention):
        s = cfg.ssm
        if s is None:
            raise ValueError(f"{cfg.name}: HybridLM takes a config with ssm")
        self.cfg = cfg
        self.attention = attention
        self.every = s.shared_block_every
        if cfg.num_layers % self.every:
            raise ValueError("hybrid: num_layers must be a multiple of shared_block_every")
        self.groups = cfg.num_layers // self.every
        self._ssd_names = tuple(ssd.ssd_specs(cfg))

    def _attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **kw) -> torch.Tensor:
        if q.dtype != k.dtype:
            return self.attention(q.to(k.dtype), k, v, **kw).to(q.dtype)
        return self.attention(q, k, v, **kw)

    @staticmethod
    def _shared(params: Params) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        return ({n: params[f"shared_attn/{n}"] for n in _ATTN}, {n: params[f"shared_mlp/{n}"] for n in _FFN})

    def _ssd_layers(self, params: Params) -> List[Dict[str, torch.Tensor]]:
        """Each Mamba2 block's parameters, in order (group-major): views of
        the stacked ``[groups, every, ...]`` tensors, taken apart with one
        ``unbind`` a tensor (under grad its backward is one stack)."""
        parts = {n: params[f"groups/{n}"].flatten(0, 1).unbind(0) for n in self._ssd_names}
        return [{n: parts[n][i] for n in self._ssd_names} for i in range(self.cfg.num_layers)]

    def _shared_block(self, shared, x, positions, *, cache=None, cache_len=None, ring=False):
        attn, mlp = shared
        cfg = self.cfg
        if cache is not None and ring:
            if x.shape[1] != 1:
                raise ValueError(f"hybrid: a ring-cache decode step takes one token, got {x.shape[1]}")
            h = rms_norm(x, attn["ln"])
            q = blocks._split_heads(h @ attn["wq"], cfg.num_heads)
            k = blocks._split_heads(h @ attn["wk"], cfg.num_kv_heads)
            v = blocks._split_heads(h @ attn["wv"], cfg.num_kv_heads)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            slot = _ring_slot(cache_len, cache["k"].shape[2])
            cache["k"][:, :, slot : slot + 1] = k
            cache["v"][:, :, slot : slot + 1] = v
            out = _ring_attention_step(self._attention, q, cache["k"], cache["v"], cache_len, cfg.attn_softcap)
            x = x + blocks._merge_heads(out) @ attn["wo"]
            kv = cache
        else:
            x, kv = blocks.attn_apply(cfg, attn, x, positions=positions, attention=self._attention, cache=cache,
                                      cache_len=cache_len)
        return blocks.mlp_apply(mlp, x), kv

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return (rms_norm(x, params["final_ln"]) @ params["head"]).float()

    # -- forward (teacher-forced) ----------------------------------------------

    def forward(self, params: Params, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` (f32) of ``{"tokens": [B, S]}``.
        Differentiable with respect to the parameter dict: each Mamba2
        block is recomputed in the backward (``torch.utils.checkpoint``, as
        the JAX forward's ``jax.checkpoint``), so a step keeps one block's
        chunk weights at a time; the shared block's calls read one set of
        weights, so its gradient is their sum."""
        refuse_mesh(self.cfg, params, "Mamba2 blocks and the shared attention block")
        x = params["embed"][batch["tokens"]]
        positions = torch.arange(x.shape[1], device=x.device)
        layers = self._ssd_layers(params)
        shared = self._shared(params)
        cfg = self.cfg
        names = self._ssd_names

        def block(h, *ps):
            return ssd.ssd_block_apply(cfg, dict(zip(names, ps)), h)[0]

        for i, lp in enumerate(layers):
            if torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(block, x, *(lp[n] for n in names), use_reentrant=False)
            else:
                x = block(x, *(lp[n] for n in names))
            if (i + 1) % self.every == 0:
                x, _ = self._shared_block(shared, x, positions)
        return self._head(params, x)

    # -- caches ------------------------------------------------------------------

    def cache_specs(self, batch_size: int, max_len: int, *, ring: bool = False) -> Dict[str, Dict[str, ParamSpec]]:
        """The JAX ``cache_specs``: ``{"ssd": {"conv": [groups, every, B,
        K-1, conv_dim], "state": [groups, every, B, H, P, N]}, "attn": {"k",
        "v": [groups, B, Hkv, m, hd]}}``, ``m`` the ring's ``min(max_len,
        sliding_window)`` with ``ring``, else ``max_len``."""
        cfg = self.cfg
        b = batch_size
        _, nheads, p, n, conv_dim = ssd.ssd_dims(cfg)
        m = min(max_len, cfg.sliding_window) if ring and cfg.sliding_window else max_len
        ssd_c = {"conv": spec((b, cfg.ssm.d_conv - 1, conv_dim), ("batch", None, "ssm_inner")),
                 "state": spec((b, nheads, p, n), ("batch", "ssm_heads", None, "ssm_state"))}
        kv = spec((b, cfg.num_kv_heads, m, cfg.resolved_head_dim), ("batch", "kv_heads", "seq", "head_dim"))
        return {"ssd": stack_layers(stack_layers(ssd_c, self.every), self.groups),
                "attn": stack_layers({"k": kv, "v": kv}, self.groups)}

    def init_cache(self, batch_size: int, max_len: int, dtype: torch.dtype, device, *, ring: bool = False) -> Cache:
        """Zeroed caches of :meth:`cache_specs`, every entry f32 whatever
        ``dtype`` (the SSM states and the small window caches stay f32, as
        the JAX package's ``init_cache``)."""
        del dtype
        return map_specs(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device),
                         self.cache_specs(batch_size, max_len, ring=ring))

    # -- prefill -------------------------------------------------------------------

    def prefill(
        self, params: Params, batch: Mapping[str, torch.Tensor], *, max_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Cache, int]:
        """Forward over the prompt that also fills the caches: each
        Mamba2 block's conv rows (the activations' dtype) and final state
        (f32), the shared block's K/V in the activations' dtype in the
        first positions of ``max_len`` slots (default: the prompt length).
        Returns the last position's logits ``[B, 1, vocab]``, the cache and
        its length."""
        refuse_mesh(self.cfg, params, "Mamba2 blocks and the shared attention block")
        x = params["embed"][batch["tokens"]]
        b, s, _ = x.shape
        specs = self.cache_specs(b, max_len or s)
        cache = {"ssd": {"conv": torch.zeros(specs["ssd"]["conv"].shape, dtype=x.dtype, device=x.device),
                         "state": torch.zeros(specs["ssd"]["state"].shape, dtype=torch.float32, device=x.device)},
                 "attn": {n: torch.zeros(t.shape, dtype=x.dtype, device=x.device) for n, t in specs["attn"].items()}}
        positions = torch.arange(s, device=x.device)
        shared = self._shared(params)
        for i, lp in enumerate(self._ssd_layers(params)):
            g, e = divmod(i, self.every)
            x, c = ssd.ssd_block_apply(self.cfg, lp, x)
            for n, t in c.items():
                cache["ssd"][n][g, e].copy_(t)
            if e == self.every - 1:
                x, kv = self._shared_block(shared, x, positions)
                for n, t in kv.items():
                    cache["attn"][n][g, :, :, :s].copy_(t)
        return self._head(params, x[:, -1:]), cache, s

    # -- decode ------------------------------------------------------------------------

    def decode(
        self, params: Params, cache: Cache, tokens: torch.Tensor, cache_len: int, *, ring: bool = False
    ) -> Tuple[torch.Tensor, Cache]:
        """``tokens [B, S]`` at positions ``cache_len ..``: each Mamba2
        block continues from its cached conv rows and state (one step of
        the recurrence for ``S == 1``), the shared block attends over its
        cache (with ``ring``, a ring-buffer window cache of
        ``init_cache(..., ring=True)``, one token a step). Writes the
        caches in place and returns them with the logits ``[B, S,
        vocab]``."""
        refuse_mesh(self.cfg, params, "Mamba2 blocks and the shared attention block")
        x = params["embed"][tokens]
        positions = cache_len + torch.arange(x.shape[1], device=x.device)
        shared = self._shared(params)
        conv, state = cache["ssd"]["conv"], cache["ssd"]["state"]
        for i, lp in enumerate(self._ssd_layers(params)):
            g, e = divmod(i, self.every)
            x, c = ssd.ssd_block_apply(self.cfg, lp, x, cache={"conv": conv[g, e], "state": state[g, e]})
            conv[g, e].copy_(c["conv"])
            state[g, e].copy_(c["state"])
            if e == self.every - 1:
                kv = {n: t[g] for n, t in cache["attn"].items()}
                x, _ = self._shared_block(shared, x, positions, cache=kv, cache_len=cache_len, ring=ring)
        return self._head(params, x), cache


class XLSTMLM:
    """The xLSTM LM (xlstm-350m): ``num_layers`` blocks in ``pairs`` of
    ``xlstm.slstm_every``, each pair ``slstm_every - 1`` mLSTM blocks then
    one sLSTM block, then the final norm and an untied head; the JAX
    package's ``XLSTMLM``. No attention and no kernel of its own: its
    blocks are PyTorch ops (cuBLAS products and elementwise kernels on the
    card). Parameters are the flat dict a replica registers
    (:func:`repro_torch.models.params.decoder_shapes`), taken apart with
    views, so serving makes no copy of them.

    ``mlstm`` is the form of the mLSTM in a cacheless call of more than one
    token (``forward``, the training step's loss): ``"chunked"`` (the
    default, the JAX package's) or ``"parallel"`` (the quadratic form, a
    reference for it). Prefill and decode always run the chunked form and
    the one-step recurrence, which carry the state."""

    def __init__(self, cfg: ModelConfig, *, mlstm: str = "chunked"):
        x = cfg.xlstm
        if x is None:
            raise ValueError(f"{cfg.name}: XLSTMLM takes a config with xlstm")
        if mlstm not in ("chunked", "parallel"):
            raise ValueError(f"xlstm: unknown mLSTM form {mlstm!r}")
        self.cfg = cfg
        self.mlstm = mlstm
        self.every = x.slstm_every
        if cfg.num_layers % self.every:
            raise ValueError("xlstm: num_layers must be a multiple of slstm_every")
        self.pairs = cfg.num_layers // self.every
        self.n_mlstm_per_pair = self.every - 1
        self._m_names = tuple(xlstm_blocks.mlstm_specs(cfg))
        self._s_names = tuple(xlstm_blocks.slstm_specs(cfg))

    def _blocks(self, params: Params) -> Tuple[List[Dict[str, torch.Tensor]], List[Dict[str, torch.Tensor]]]:
        """Each mLSTM block's parameters (pair-major) and each sLSTM
        block's: views of the stacked tensors, one ``unbind`` a tensor
        (under grad its backward is one stack)."""
        m = {n: params[f"pairs/mlstm/{n}"].flatten(0, 1).unbind(0) for n in self._m_names}
        s = {n: params[f"pairs/slstm/{n}"].unbind(0) for n in self._s_names}
        return ([{n: m[n][i] for n in self._m_names} for i in range(self.pairs * self.n_mlstm_per_pair)],
                [{n: s[n][i] for n in self._s_names} for i in range(self.pairs)])

    def _run(self, params: Params, x: torch.Tensor, cache: Optional[Cache] = None, *,
             form: str = "chunked") -> Tuple[torch.Tensor, Dict[str, Dict[str, List[torch.Tensor]]]]:
        """Every block in order from ``cache`` (zero states when None).
        Returns the activations and each block's new state by name, in
        block order: ``{"mlstm": {n: [each mLSTM block's, pair-major]},
        "slstm": {n: [each pair's sLSTM block's]}}``."""
        cfg = self.cfg
        m_layers, s_layers = self._blocks(params)
        new: Dict[str, Dict[str, List]] = {"mlstm": {}, "slstm": {}}
        for p in range(self.pairs):
            for j in range(self.n_mlstm_per_pair):
                c = None if cache is None else {n: t[p, j] for n, t in cache["mlstm"].items()}
                x, st = xlstm_blocks.mlstm_block_apply(cfg, m_layers[p * self.n_mlstm_per_pair + j], x, cache=c,
                                                       form=form)
                for n, t in st.items():
                    new["mlstm"].setdefault(n, []).append(t)
            c = None if cache is None else {n: t[p] for n, t in cache["slstm"].items()}
            x, st = xlstm_blocks.slstm_block_apply(cfg, s_layers[p], x, cache=c)
            for n, t in st.items():
                new["slstm"].setdefault(n, []).append(t)
        return x, new

    def _store(self, cache: Cache, new) -> None:
        """Write the states :meth:`_run` returned into ``cache`` in place."""
        k = self.n_mlstm_per_pair
        for n, states in new["mlstm"].items():
            for i, t in enumerate(states):
                cache["mlstm"][n][divmod(i, k)].copy_(t)
        for n, states in new["slstm"].items():
            for p, t in enumerate(states):
                cache["slstm"][n][p].copy_(t)

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return (rms_norm(x, params["final_ln"]) @ params["head"]).float()

    # -- forward (teacher-forced) ----------------------------------------------

    def forward(self, params: Params, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` (f32) of ``{"tokens": [B, S]}``, every
        block from a zero state (the JAX forward's fresh ``init_cache``).
        Differentiable with respect to the parameter dict; nothing is
        recomputed in the backward (the JAX ``_run`` has no
        ``jax.checkpoint``)."""
        refuse_mesh(self.cfg, params, "mLSTM and sLSTM blocks")
        x = params["embed"][batch["tokens"]]
        x, _ = self._run(params, x, form=self.mlstm)
        return self._head(params, x)

    # -- caches ------------------------------------------------------------------

    def cache_specs(self, batch_size: int, max_len: int, *, ring: bool = False) -> Dict[str, Dict[str, ParamSpec]]:
        """The JAX ``cache_specs``, which do not depend on ``max_len`` or
        ``ring``: ``{"mlstm": {"c": [pairs, slstm_every - 1, B, H, dh, dh],
        "n": [.., B, H, dh], "m": [.., B, H]}, "slstm": {"h", "c", "n", "m":
        [pairs, B, H, d_model / H]}}``."""
        del max_len, ring  # the recurrent state is O(1) in the sequence's length
        b = batch_size
        _, nh, dh = xlstm_blocks.mlstm_dims(self.cfg)
        dhs = self.cfg.d_model // self.cfg.num_heads
        m_state = {
            "c": spec((b, nh, dh, dh), ("batch", "ssm_heads", None, None), init="zeros"),
            "n": spec((b, nh, dh), ("batch", "ssm_heads", None), init="zeros"),
            "m": spec((b, nh), ("batch", "ssm_heads"), init="zeros"),
        }
        s_state = {n: spec((b, nh, dhs), ("batch", "ssm_heads", None), init="zeros") for n in ("h", "c", "n", "m")}
        return {"mlstm": stack_layers(stack_layers(m_state, self.n_mlstm_per_pair), self.pairs),
                "slstm": stack_layers(s_state, self.pairs)}

    def init_cache(self, batch_size: int, max_len: int, dtype: torch.dtype, device) -> Cache:
        """The states of :meth:`cache_specs`, all f32 whatever ``dtype``
        (as the JAX package's ``init_cache``): zeros, but both stabilisers
        ``m`` at -1e30."""
        del dtype
        cache = map_specs(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device),
                          self.cache_specs(batch_size, max_len))
        cache["mlstm"]["m"].fill_(xlstm_blocks.M_START)
        cache["slstm"]["m"].fill_(xlstm_blocks.M_START)
        return cache

    # -- prefill -------------------------------------------------------------------

    def prefill(
        self, params: Params, batch: Mapping[str, torch.Tensor], *, max_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Cache, int]:
        """Forward over the prompt from a fresh :meth:`init_cache` that
        leaves every block's final state in it. Returns the last position's
        logits ``[B, 1, vocab]``, the cache and its length (``max_len`` is
        taken for the decoder's signature; a recurrent cache has no
        slots)."""
        refuse_mesh(self.cfg, params, "mLSTM and sLSTM blocks")
        x = params["embed"][batch["tokens"]]
        b, s, _ = x.shape
        cache = self.init_cache(b, max_len or s, x.dtype, x.device)
        x, new = self._run(params, x, cache)
        self._store(cache, new)
        return self._head(params, x[:, -1:]), cache, s

    # -- decode ------------------------------------------------------------------------

    def decode(
        self, params: Params, cache: Cache, tokens: torch.Tensor, cache_len: int
    ) -> Tuple[torch.Tensor, Cache]:
        """``tokens [B, S]`` after the cached states: each mLSTM block runs
        one step of its recurrence for ``S == 1`` and the chunked form from
        its state for ``S > 1``, each sLSTM block its loop. ``cache_len`` is
        not read (a recurrent cache has no position). Writes the cache in
        place and returns it with the logits ``[B, S, vocab]``."""
        del cache_len
        refuse_mesh(self.cfg, params, "mLSTM and sLSTM blocks")
        x = params["embed"][tokens]
        x, new = self._run(params, x, cache)
        self._store(cache, new)
        return self._head(params, x), cache
