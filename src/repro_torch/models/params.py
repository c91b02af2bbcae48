"""Parameter names and shapes of the decoder and encoder LMs, and weight
carry-across.

``decoder_shapes`` lists what the JAX package's
``named_tensors(DecoderLM(cfg).param_specs())`` yields:
the same names, the same shapes (the scanned layer axis stacked first),
in JAX's pytree order (dict keys sorted at every level, list items in
order); for an encoder-only config (hubert) it lists the JAX
``EncoderLM``'s instead (``frame_proj``, the stacked ``layers/attn`` and
the GELU MLP's ``layers/ffn/{ln,w_up,b_up,w_down,b_down}``, ``final_ln``,
``head``). As the JAX package's ``blocks.attn_specs`` and ``mlp_specs``, a
softcapped model (gemma2) has a ``post_ln`` in both blocks, and a model
with tied embeddings no ``head``. A MoE model's stacked FFN is
``moe_specs``' (``ln``, ``router``, the experts' ``w_gate``/``w_up``
``[L, E, d, fe]`` and ``w_down`` ``[L, E, fe, d]``, the shared expert's
``shared_*`` with ``num_shared``); its first ``first_dense`` layers are
``prefix/<i>/{attn,ffn}/...``, unstacked, with a dense FFN of
``d_ff_dense``, and the stack holds the rest. An MLA model's attention
(deepseek-v3's, stacked and in the prefix) is ``mla_specs``' (``ln``,
``wq_a``, ``q_ln``, ``wq_b``, ``wkv_a``, ``kv_ln``, ``wkv_b_k``,
``wkv_b_v``, ``wo``; the two norms end in ``ln``, so ``init_params``
draws them as zeros, as ``init="zeros"`` does). The transfer-unit
schedule (``build_units``) follows registration order, so a replica
registered in this order has the same units, and the same manifest, as
the JAX package's.

A hybrid config (zamba2) lists the JAX ``HybridLM``'s: ``embed``,
``final_ln``, the Mamba2 blocks' ``groups/{a_log, conv_b, conv_w, d_skip,
dt_bias, ln, norm, w_in, w_out}`` stacked ``[groups, shared_block_every,
...]``, ``head``, and the one shared block's ``shared_attn/{ln, wk, wo,
wq, wv}`` and ``shared_mlp/{ln, w_down, w_gate, w_up}``.

An SSM config (xlstm-350m) lists the JAX ``XLSTMLM``'s: ``embed``,
``final_ln``, ``head``, the mLSTM blocks' ``pairs/mlstm/{b_if, ln, w_down,
w_if, w_up, wk, wq, wv}`` stacked ``[pairs, slstm_every - 1, ...]`` and the
sLSTM blocks' ``pairs/slstm/{b_gates, ln, r_gates, w_gates, w_out}``
stacked ``[pairs, ...]``.

``init_params`` makes random weights by the JAX package's ``init_tree``
rule, each tensor drawn as its spec's ``init`` says (``INIT_KINDS``: the
norms, the encoder's biases, the SSD's ``conv_b``, ``a_log`` and
``dt_bias`` and the xLSTM's gate biases zeros, the SSD's ``d_skip`` ones,
the rest normal, at the spec's ``scale`` where ``INIT_SCALE`` names one:
the sLSTM's ``r_gates`` at half the std), from a
``torch.Generator``: the numbers differ from ``jax.random``'s, so parity
tests carry JAX weights across with ``from_numpy`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HYBRID, SSM, ModelConfig
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B

# through the core package: transfer.engine and core.client import each
# other, and only core-first resolves (engine-first is circular)
from repro_torch.core.client import resolve_device
from repro_torch.models.blocks import mla_shapes, moe_shapes
from repro_torch.models.ssd import SSD_INIT, ssd_shapes
from repro_torch.models.xlstm_blocks import XLSTM_INIT, XLSTM_SCALE, mlstm_shapes, slstm_shapes

Shape = Tuple[int, ...]

#: ``spec(..., init=)`` of every parameter that is not drawn normal, by the
#: last part of its name: the norms of every block and the final one, the
#: encoder MLP's biases, the Mamba2 block's (``SSD_INIT``) and the xLSTM
#: blocks' gate biases (``XLSTM_INIT``)
INIT_KINDS = {
    "ln": "zeros", "post_ln": "zeros", "q_ln": "zeros", "kv_ln": "zeros", "final_ln": "zeros",
    "b_up": "zeros", "b_down": "zeros", **SSD_INIT, **XLSTM_INIT,
}
#: ``spec(..., scale=)`` of every parameter drawn normal at another std than
#: ``1/sqrt(shape[-2])``, by the last part of its name: the sLSTM's
#: recurrent matrices (``XLSTM_SCALE``)
INIT_SCALE = {**XLSTM_SCALE}


def _attn_tree(cfg: ModelConfig) -> Dict[str, Shape]:
    if cfg.mla is not None:  # deepseek-v3's multi-head latent attention
        return mla_shapes(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    tree = {
        "ln": (d,),
        "wq": (d, cfg.num_heads * hd),
        "wk": (d, cfg.num_kv_heads * hd),
        "wv": (d, cfg.num_kv_heads * hd),
        "wo": (cfg.num_heads * hd, d),
    }
    if cfg.attn_softcap > 0:  # gemma2 also post-norms each block's output
        tree["post_ln"] = (d,)
    return tree


def _mlp_tree(cfg: ModelConfig, d_ff: int) -> Dict[str, Shape]:
    d = cfg.d_model
    tree = {"ln": (d,), "w_gate": (d, d_ff), "w_up": (d, d_ff), "w_down": (d_ff, d)}
    if cfg.attn_softcap > 0:
        tree["post_ln"] = (d,)
    return tree


def _encoder_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX ``EncoderLM.param_specs()`` (hubert): the frame projection,
    the stacked attention and GELU MLP, the final norm and the head."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    return {
        "frame_proj": (cfg.frontend_dim, d),
        "layers": {
            "attn": {n: (L, *s) for n, s in _attn_tree(cfg).items()},
            "ffn": {"ln": (L, d), "w_up": (L, d, f), "b_up": (L, f), "w_down": (L, f, d), "b_down": (L, d)},
        },
        "final_ln": (d,),
        "head": (d, cfg.vocab),
    }


def _hybrid_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX ``HybridLM.param_specs()`` (zamba2): the Mamba2 blocks
    stacked ``[groups, shared_block_every, ...]`` and one shared attention
    block and MLP, called after every group."""
    every = cfg.ssm.shared_block_every
    groups = cfg.num_layers // every
    return {
        "embed": (cfg.vocab, cfg.d_model),
        "groups": {n: (groups, every, *s) for n, s in ssd_shapes(cfg).items()},
        "shared_attn": _attn_tree(cfg),
        "shared_mlp": _mlp_tree(cfg, cfg.d_ff),
        "final_ln": (cfg.d_model,),
        "head": (cfg.d_model, cfg.vocab),
    }


def _xlstm_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX ``XLSTMLM.param_specs()`` (xlstm-350m): ``slstm_every``
    blocks a pair, the mLSTM blocks stacked ``[pairs, slstm_every - 1,
    ...]`` and the one sLSTM block ``[pairs, ...]``."""
    every = cfg.xlstm.slstm_every
    pairs = cfg.num_layers // every
    return {
        "embed": (cfg.vocab, cfg.d_model),
        "pairs": {
            "mlstm": {n: (pairs, every - 1, *s) for n, s in mlstm_shapes(cfg).items()},
            "slstm": {n: (pairs, *s) for n, s in slstm_shapes(cfg).items()},
        },
        "final_ln": (cfg.d_model,),
        "head": (cfg.d_model, cfg.vocab),
    }


def _spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.encoder_only:
        return _encoder_tree(cfg)
    if cfg.family == HYBRID:
        return _hybrid_tree(cfg)
    if cfg.family == SSM:
        return _xlstm_tree(cfg)
    mo = cfg.moe
    n_prefix = mo.first_dense if mo is not None else 0
    L = cfg.num_layers - n_prefix
    ffn = moe_shapes(cfg) if mo is not None else _mlp_tree(cfg, cfg.d_ff)
    tree: Dict[str, Any] = {
        "embed": (cfg.vocab, cfg.d_model),
        "layers": {
            "attn": {n: (L, *s) for n, s in _attn_tree(cfg).items()},
            "ffn": {n: (L, *s) for n, s in ffn.items()},
        },
        "final_ln": (cfg.d_model,),
    }
    if n_prefix:
        dense = {"attn": _attn_tree(cfg), "ffn": _mlp_tree(cfg, mo.d_ff_dense)}
        tree["prefix"] = [dense] * n_prefix
    if not cfg.tie_embeddings:
        tree["head"] = (cfg.d_model, cfg.vocab)
    return tree


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Shape]]:
    """JAX's pytree order: dict keys sorted, list items by index."""
    items = enumerate(tree) if isinstance(tree, list) else ((k, tree[k]) for k in sorted(tree))
    out: List[Tuple[str, Shape]] = []
    for key, v in items:
        if isinstance(v, (dict, list)):
            out.extend(_flatten(v, f"{prefix}{key}/"))
        else:
            out.append((f"{prefix}{key}", tuple(v)))
    return out


def decoder_shapes(cfg: ModelConfig) -> List[Tuple[str, Shape]]:
    """``(name, shape)`` of every parameter of ``cfg``'s model (the
    decoder's, an encoder-only config's encoder, a hybrid config's
    ``HybridLM``, an SSM config's ``XLSTMLM``), in registration order."""
    return _flatten(_spec_tree(cfg))


def llama3_8b_shapes(num_layers: int = 32) -> List[Tuple[str, Shape]]:
    """llama3-8b at its published widths, with ``num_layers`` layers."""
    return decoder_shapes(dataclasses.replace(LLAMA3_8B, num_layers=num_layers))


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Random parameters of ``cfg``, in registration order, on ``device``
    (the card unless the caller asks for the CPU; ``generator`` must live
    on the same device). As ``init_tree``: the tensors ``INIT_KINDS``
    names by their last part are zeros or ones, every other tensor normal
    with std ``scale/sqrt(shape[-2])`` (``scale`` from ``INIT_SCALE``, 1
    where it names none), drawn in f32 and cast to ``dtype``. A stacked
    tensor is drawn one matrix at a time (a layer's, or a layer's expert's),
    so the f32 temporary is one matrix's, not the whole stack's: dbrx's
    ``w_gate`` at 4 layers would be a 17 GB f32 temporary."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in decoder_shapes(cfg):
        kind = INIT_KINDS.get(name.rsplit("/", 1)[-1], "normal")
        t = torch.zeros(shape, dtype=dtype, device=dev)
        if kind == "ones":
            t.fill_(1)
        elif kind == "normal":
            std = INIT_SCALE.get(name.rsplit("/", 1)[-1], 1.0) / np.sqrt(shape[-2])
            for part in t.view(-1, *shape[-2:]):
                part.copy_(
                    torch.randn(part.shape, generator=generator, dtype=torch.float32, device=dev).mul_(std)
                )
        out[name] = t
    return out


#: numpy extension dtypes (the JAX package's bfloat16 and fp8 types),
#: which torch cannot take from numpy
_EXTENSION_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


def from_numpy(named: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Copy the JAX package's parameters (numpy arrays, e.g.
    ``np.asarray`` of JAX arrays) into torch tensors on ``device``,
    keeping names and order. Arrays of numpy's extension dtypes
    (``bfloat16``, the fp8 types) are recognised by their dtype name and
    cross as raw words of their width, so no extension dtype package is
    needed on this side."""
    out: Dict[str, torch.Tensor] = {}
    for name, arr in named.items():
        a = np.ascontiguousarray(arr)
        if a.dtype.name in _EXTENSION_DTYPES:
            words = a.view(f"uint{8 * a.dtype.itemsize}").copy()
            t = torch.from_numpy(words).view(_EXTENSION_DTYPES[a.dtype.name])
        else:
            t = torch.from_numpy(a.copy())
        out[name] = t.to(device)
    return out
