"""The dense decoder LM: forward, prefill and one-token decode.

The port's copy of the dense branch of the JAX package's ``DecoderLM``
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
transpose the head). The MoE, MLA and VLM branches and the encoder,
hybrid and xLSTM models wait for later slices
(:func:`repro_torch.models.build_model` refuses them).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
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
    """Causal decoder: dense GQA attention x SwiGLU FFN.

    ``attention`` is the attention function every layer calls, the flash
    kernel's wrapper by default; a reference computation passes
    :func:`repro_torch.kernels.flash_attention.attention_plain`."""

    def __init__(self, cfg: ModelConfig, *, attention: Callable[..., torch.Tensor] = flash_attention):
        self.cfg = cfg
        self.attention = attention
        self.windows = _layer_windows(cfg)
        post = ("post_ln",) if cfg.attn_softcap > 0 else ()
        self._attn_names, self._ffn_names = _ATTN + post, _FFN + post

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

    def _layer(self, params: Params, i: int) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        attn = {n: params[f"layers/attn/{n}"][i] for n in self._attn_names}
        ffn = {n: params[f"layers/ffn/{n}"][i] for n in self._ffn_names}
        return attn, ffn

    def _block(self, params, i, x, positions, cache=None, cache_len=None, layer=None):
        attn, ffn = layer or self._layer(params, i)
        x, kv = blocks.attn_apply(
            self.cfg, attn, x, positions=positions, attention=self.attention, window=self.windows[i],
            cache=cache, cache_len=cache_len,
        )
        return blocks.mlp_apply(ffn, x), kv

    # -- forward (teacher-forced) ----------------------------------------------

    def forward(self, params: Params, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` (f32) of a token batch ``{"tokens": [B, S]}``."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        attn = {n: params[f"layers/attn/{n}"].unbind(0) for n in self._attn_names}
        ffn = {n: params[f"layers/ffn/{n}"].unbind(0) for n in self._ffn_names}
        for i in range(self.cfg.num_layers):
            layer = ({n: t[i] for n, t in attn.items()}, {n: t[i] for n, t in ffn.items()})
            x, _ = self._block(params, i, x, positions, layer=layer)
        return self._head(params, x)

    # -- caches ------------------------------------------------------------------

    def init_cache(self, batch_size: int, max_len: int, dtype: torch.dtype, device) -> Cache:
        """Zeroed K/V caches ``[layers, B, Hkv, max_len, hd]``, keyed as the
        JAX package's (``{"layers": {"k", "v"}}``)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
        return {"layers": {n: torch.zeros(shape, dtype=dtype, device=device) for n in ("k", "v")}}

    # -- prefill -------------------------------------------------------------------

    def prefill(
        self, params: Params, batch: Mapping[str, torch.Tensor], *, max_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Cache, int]:
        """Forward over the prompt that also fills a KV cache of ``max_len``
        slots (default: the prompt length); returns the logits of the last
        position only (``[B, 1, vocab]``: at vocab 128256 a 16 x 512
        batch's full logits would take 4.2 GB), the cache and its length."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)
        cache = self.init_cache(b, max_len or s, x.dtype, x.device)
        for i in range(self.cfg.num_layers):
            x, kv = self._block(params, i, x, positions)
            cache["layers"]["k"][i, :, :, :s] = kv["k"]
            cache["layers"]["v"][i, :, :, :s] = kv["v"]
        return self._head(params, x[:, -1:]), cache, s

    # -- decode ------------------------------------------------------------------------

    def decode(
        self, params: Params, cache: Cache, tokens: torch.Tensor, cache_len: int
    ) -> Tuple[torch.Tensor, Cache]:
        """One step: ``tokens [B, 1]`` at position ``cache_len``. Writes
        the step's K/V into ``cache`` in place and returns it with the
        logits ``[B, 1, vocab]``."""
        x = self._embed(params, tokens)
        positions = cache_len + torch.arange(x.shape[1], device=x.device)
        layers = cache["layers"]
        for i in range(self.cfg.num_layers):
            c = {"k": layers["k"][i], "v": layers["v"][i]}
            x, _ = self._block(params, i, x, positions, cache=c, cache_len=cache_len)
        return self._head(params, x), cache
