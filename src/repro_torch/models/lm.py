"""The decoder LM: forward, prefill and one-token decode.

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
logits cover both, and ``decode`` continues from ``P + prompt_len``. The
encoder, hybrid and xLSTM models wait for later slices
(:func:`repro_torch.models.build_model` refuses them).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import VLM, ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.models import blocks
from repro_torch.models.layers import rms_norm, softcap

Params = Mapping[str, torch.Tensor]
Cache = Dict[str, Dict[str, torch.Tensor]]

_ATTN = ("ln", "wq", "wk", "wv", "wo")
_FFN = ("ln", "w_gate", "w_up", "w_down")


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Each layer's sliding window (0 = global attention): gemma2's even
    layers are local, its odd layers global, as the JAX package's
    ``_layer_windows`` (its ``long_mode`` belongs to the hybrid family)."""
    if cfg.alt_local_global:
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(cfg.num_layers)]
    return [0] * cfg.num_layers


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
        self._attn_names = tuple(blocks.mla_shapes(cfg)) if self.is_mla else _ATTN + post
        self._dense_names = _FFN + post
        if self.is_moe:
            self._ffn_names = tuple(blocks.moe_shapes(cfg))
        else:
            self._ffn_names = self._dense_names

    # -- embedding / head ------------------------------------------------------

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        x = params["embed"][tokens]
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
                    slots[j][n].narrow(self.seq_axis, 0, t.shape[self.seq_axis]).copy_(t)
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
        + S, vocab]``)."""
        x, positions = self._inputs(params, batch)
        attn = {n: params[f"layers/attn/{n}"].unbind(0) for n in self._attn_names}
        ffn = {n: params[f"layers/ffn/{n}"].unbind(0) for n in self._ffn_names}

        def layers(i):
            return {n: t[i] for n, t in attn.items()}, {n: t[i] for n, t in ffn.items()}

        return self._head(params, self._run(params, x, positions, layers=layers))

    # -- caches ------------------------------------------------------------------

    def init_cache(self, batch_size: int, max_len: int, dtype: torch.dtype, device) -> Cache:
        """Zeroed caches, keyed as the JAX package's: ``{"layers": {"k",
        "v"}}`` stacked ``[stacked layers, B, Hkv, max_len, hd]`` (MLA:
        ``{"ckv", "krope"}`` stacked ``[stacked layers, B, max_len, R]`` and
        ``[.., rd]``), and with a dense prefix ``"prefix"``, a list of one
        such dict a layer."""
        cfg = self.cfg
        if self.is_mla:
            m = cfg.mla
            shapes = {"ckv": (batch_size, max_len, m.kv_lora_rank), "krope": (batch_size, max_len, m.qk_rope_head_dim)}
        else:
            kv = (batch_size, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
            shapes = {"k": kv, "v": kv}

        def zeros(*lead):
            return {n: torch.zeros(lead + shape, dtype=dtype, device=device) for n, shape in shapes.items()}

        cache: Cache = {"layers": zeros(self.n_scan)}
        if self.n_prefix:
            cache["prefix"] = [zeros() for _ in range(self.n_prefix)]
        return cache

    # -- prefill -------------------------------------------------------------------

    def prefill(
        self, params: Params, batch: Mapping[str, torch.Tensor], *, max_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Cache, int]:
        """Forward over the prompt that also fills a KV cache of ``max_len``
        slots (default: the prompt length); returns the logits of the last
        position only (``[B, 1, vocab]``: at vocab 128256 a 16 x 512
        batch's full logits would take 4.2 GB), the cache and its length.
        A VLM's patches come first: its cache length is ``P + prompt_len``,
        and ``max_len`` counts the patches."""
        x, positions = self._inputs(params, batch)
        b, s, _ = x.shape
        cache = self.init_cache(b, max_len or s, x.dtype, x.device)
        x = self._run(params, x, positions, slots=self._slots(cache))
        return self._head(params, x[:, -1:]), cache, s

    # -- decode ------------------------------------------------------------------------

    def decode(
        self, params: Params, cache: Cache, tokens: torch.Tensor, cache_len: int
    ) -> Tuple[torch.Tensor, Cache]:
        """One step: ``tokens [B, 1]`` at position ``cache_len``. Writes
        the step's K/V (MLA: latent and rope key) into ``cache`` in place
        and returns it with the logits ``[B, 1, vocab]``."""
        x = self._embed(params, tokens)
        positions = cache_len + torch.arange(x.shape[1], device=x.device)
        x = self._run(params, x, positions, slots=self._slots(cache), cache_len=cache_len)
        return self._head(params, x), cache
