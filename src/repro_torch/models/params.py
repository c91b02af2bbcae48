"""Parameter names and shapes of the decoder LM, and weight carry-across.

``decoder_shapes`` lists what the JAX package's
``named_tensors(DecoderLM(cfg).param_specs())`` yields for a dense model:
the same names, the same shapes (the scanned layer axis stacked first),
in JAX's pytree order (dict keys sorted at every level). The transfer-unit
schedule (``build_units``) follows registration order, so a replica
registered in this order has the same units, and the same manifest, as
the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B
from repro_torch.configs.llama3_8b import DecoderConfig

Shape = Tuple[int, ...]


def _spec_tree(cfg: DecoderConfig) -> Dict[str, Any]:
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


def decoder_shapes(cfg: DecoderConfig) -> List[Tuple[str, Shape]]:
    """``(name, shape)`` of every parameter, in registration order."""
    return _flatten(_spec_tree(cfg))


def llama3_8b_shapes(num_layers: int = 32) -> List[Tuple[str, Shape]]:
    """llama3-8b at its published widths, with ``num_layers`` layers."""
    return decoder_shapes(dataclasses.replace(LLAMA3_8B, num_layers=num_layers))


def from_numpy(named: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Copy the JAX package's parameters (numpy arrays, e.g.
    ``np.asarray`` of JAX arrays) into torch tensors on ``device``,
    keeping names and order. ``bfloat16`` arrays are recognised by their
    dtype name and cross as raw 16-bit words, so no extension dtype
    package is needed on this side."""
    out: Dict[str, torch.Tensor] = {}
    for name, arr in named.items():
        a = np.ascontiguousarray(arr)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        out[name] = t.to(device)
    return out
