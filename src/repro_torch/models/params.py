"""Parameter names and shapes of the decoder LM, and weight carry-across.

``decoder_shapes`` lists what the JAX package's
``named_tensors(DecoderLM(cfg).param_specs())`` yields:
the same names, the same shapes (the scanned layer axis stacked first),
in JAX's pytree order (dict keys sorted at every level, list items in
order). As the JAX package's ``blocks.attn_specs`` and ``mlp_specs``, a
softcapped model (gemma2) has a ``post_ln`` in both blocks, and a model
with tied embeddings no ``head``. A MoE model's stacked FFN is
``moe_specs``' (``ln``, ``router``, the experts' ``w_gate``/``w_up``
``[L, E, d, fe]`` and ``w_down`` ``[L, E, fe, d]``, the shared expert's
``shared_*`` with ``num_shared``); its first ``first_dense`` layers are
``prefix/<i>/{attn,ffn}/...``, unstacked, with a dense FFN of
``d_ff_dense``, and the stack holds the rest. The transfer-unit
schedule (``build_units``) follows registration order, so a replica
registered in this order has the same units, and the same manifest, as
the JAX package's.

``init_params`` makes random weights by the JAX package's ``init_tree``
rule, from a ``torch.Generator``: the numbers differ from ``jax.random``'s,
so parity tests carry JAX weights across with ``from_numpy`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B

# through the core package: transfer.engine and core.client import each
# other, and only core-first resolves (engine-first is circular)
from repro_torch.core.client import resolve_device
from repro_torch.models.blocks import moe_shapes

Shape = Tuple[int, ...]


def _attn_tree(cfg: ModelConfig) -> Dict[str, Shape]:
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


def _spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
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
    """``(name, shape)`` of every parameter, in registration order."""
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
    on the same device). As ``init_tree``: norms (``.../ln``,
    ``final_ln``) are zeros, every other tensor normal with std
    ``1/sqrt(shape[-2])``, drawn in f32 and cast to ``dtype``. A stacked
    tensor is drawn one matrix at a time (a layer's, or a layer's expert's),
    so the f32 temporary is one matrix's, not the whole stack's: dbrx's
    ``w_gate`` at 4 layers would be a 17 GB f32 temporary."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in decoder_shapes(cfg):
        t = torch.zeros(shape, dtype=dtype, device=dev)
        if not name.endswith("ln"):
            std = 1.0 / np.sqrt(shape[-2])
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
