"""Parameter names and shapes of the decoder LM, and weight carry-across.

``decoder_shapes`` lists what the JAX package's
``named_tensors(DecoderLM(cfg).param_specs())`` yields for a dense model:
the same names, the same shapes (the scanned layer axis stacked first),
in JAX's pytree order (dict keys sorted at every level). As the JAX
package's ``blocks.attn_specs`` and ``mlp_specs``, a softcapped model
(gemma2) has a ``post_ln`` in both blocks, and a model with tied
embeddings no ``head``. The transfer-unit
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

Shape = Tuple[int, ...]


def _spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    tree: Dict[str, Any] = {
        "embed": (cfg.vocab, d),
        "layers": {
            "attn": {
                "ln": (L, d),
                "wq": (L, d, cfg.num_heads * hd),
                "wk": (L, d, cfg.num_kv_heads * hd),
                "wv": (L, d, cfg.num_kv_heads * hd),
                "wo": (L, cfg.num_heads * hd, d),
            },
            "ffn": {
                "ln": (L, d),
                "w_gate": (L, d, cfg.d_ff),
                "w_up": (L, d, cfg.d_ff),
                "w_down": (L, cfg.d_ff, d),
            },
        },
        "final_ln": (d,),
    }
    if cfg.attn_softcap > 0:  # gemma2 also post-norms each block's output
        tree["layers"]["attn"]["post_ln"] = (L, d)
        tree["layers"]["ffn"]["post_ln"] = (L, d)
    if not cfg.tie_embeddings:
        tree["head"] = (d, cfg.vocab)
    return tree


def _flatten(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Shape]]:
    out: List[Tuple[str, Shape]] = []
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out.extend(_flatten(v, f"{prefix}{key}/"))
        else:
            out.append((prefix + key, tuple(v)))
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
    tensor is drawn one layer at a time, so the f32 temporary is one
    layer's, not the whole stack's."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in decoder_shapes(cfg):
        t = torch.zeros(shape, dtype=dtype, device=dev)
        if not name.endswith("ln"):
            std = 1.0 / np.sqrt(shape[-2])
            for part in t if t.dim() == 3 else (t,):
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
