"""Parameter specs of the decoder, encoder, hybrid and xLSTM LMs (shapes,
logical sharding axes and init rules, one source of truth), and weight
carry-across.

The port's copy of the JAX package's ``models/params.py``. Every model's
parameters are a tree of :class:`ParamSpec` leaves (:func:`param_specs`),
nested dicts and lists: each leaf's ``shape``, its ``axes`` (one logical
axis name, or None, a dimension: what :mod:`repro_torch.sharding` maps to
mesh axes), its ``init`` and its ``scale``, as the JAX package's
``param_specs`` of ``DecoderLM``, ``EncoderLM``, ``HybridLM`` and
``XLSTMLM`` give them. The blocks' own specs are in their modules
(``blocks.attn_specs``, ``mla_specs``, ``mlp_specs``, ``moe_specs``,
``ssd.ssd_specs``, ``xlstm_blocks.mlstm_specs`` and ``slstm_specs``), and
:func:`stack_layers` prepends a stacked ``"layers"`` dimension (a hybrid
model's groups and an xLSTM's mLSTM blocks are stacked twice).

``decoder_specs`` lists what the JAX package's
``named_tensors(build_model(cfg).param_specs())`` yields: the same names,
the same specs (the scanned layer axis stacked first), in JAX's pytree
order (dict keys sorted at every level, list items in order). The
transfer-unit schedule (``build_units``) follows registration order, so a
replica registered in this order has the same units, and the same
manifest, as the JAX package's. ``decoder_shapes`` is its names and
shapes.

``init_params`` makes random weights by the JAX package's ``init_tree``
rule, each tensor as its spec's ``init`` says (zeros, ones, or normal at
std ``scale / sqrt(fan_in)``), from a ``torch.Generator``: the numbers
differ from ``jax.random``'s, so parity tests carry JAX weights across with
``from_numpy`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HYBRID, SSM, ModelConfig
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B

# through the core package: transfer.engine and core.client import each
# other, and only core-first resolves (engine-first is circular)
from repro_torch.core.client import resolve_device

Shape = Tuple[int, ...]
Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Shape
    axes: Axes  # logical sharding axes, len == ndim
    init: str = "normal"  # "normal" | "zeros" | "ones"
    scale: float = 1.0  # stddev multiplier on fan-in init

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"spec {self.shape} has {len(self.axes)} axes")


def spec(shape: Shape, axes: Axes, *, init: str = "normal", scale: float = 1.0) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), init=init, scale=scale)


def map_specs(fn: Callable[[ParamSpec], Any], tree: Any) -> Any:
    """``fn`` applied to every :class:`ParamSpec` of a tree of dicts and
    lists, the tree's structure kept."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, list):
        return [map_specs(fn, v) for v in tree]
    return {k: map_specs(fn, v) for k, v in tree.items()}


def stack_layers(tree: Any, num_layers: int) -> Any:
    """Prepend a scan-stacked 'layers' dimension to every spec in a tree."""
    return map_specs(
        lambda p: ParamSpec((num_layers, *p.shape), ("layers", *p.axes), init=p.init, scale=p.scale), tree
    )


def named_specs(tree: Any, prefix: str = "") -> List[Tuple[str, ParamSpec]]:
    """``(name, spec)`` of every leaf in JAX's pytree order (dict keys
    sorted, list items by index), named as ``named_tensors`` names them."""
    items = enumerate(tree) if isinstance(tree, list) else ((k, tree[k]) for k in sorted(tree))
    out: List[Tuple[str, ParamSpec]] = []
    for key, v in items:
        if isinstance(v, ParamSpec):
            out.append((f"{prefix}{key}", v))
        else:
            out.extend(named_specs(v, f"{prefix}{key}/"))
    return out


def tree_size(tree: Any) -> int:
    """Total element count of a spec tree (for param-count cross-checks)."""
    return sum(int(np.prod(p.shape)) for _, p in named_specs(tree))


def _decoder_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX ``DecoderLM.param_specs()``: the stacked layers (a MoE
    model's FFN routed, its first ``first_dense`` layers a dense ``prefix``
    list with a dense FFN of ``d_ff_dense``), MLA attention for a config
    with ``mla``, no ``head`` with tied embeddings."""
    from repro_torch.models import blocks

    mo = cfg.moe
    n_prefix = mo.first_dense if mo is not None else 0

    def layer(dense_ffn: bool) -> Dict[str, Any]:
        attn = blocks.mla_specs(cfg) if cfg.mla is not None else blocks.attn_specs(cfg)
        if dense_ffn:
            ffn = blocks.mlp_specs(cfg, mo.d_ff_dense if mo is not None else cfg.d_ff)
        else:
            ffn = blocks.moe_specs(cfg) if mo is not None else blocks.mlp_specs(cfg)
        return {"attn": attn, "ffn": ffn}

    tree: Dict[str, Any] = {
        "embed": spec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        "layers": stack_layers(layer(dense_ffn=mo is None), cfg.num_layers - n_prefix),
        "final_ln": spec((cfg.d_model,), ("act_embed",), init="zeros"),
    }
    if n_prefix:
        tree["prefix"] = [layer(dense_ffn=True) for _ in range(n_prefix)]
    if not cfg.tie_embeddings:
        tree["head"] = spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return tree


def _encoder_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX ``EncoderLM.param_specs()`` (hubert): the frame projection,
    the stacked attention and GELU MLP with its biases, the final norm and
    the head."""
    from repro_torch.models import blocks

    d, f = cfg.d_model, cfg.d_ff
    ffn = {
        "ln": spec((d,), ("act_embed",), init="zeros"),
        "w_up": spec((d, f), ("embed", "mlp")),
        "b_up": spec((f,), ("mlp",), init="zeros"),
        "w_down": spec((f, d), ("mlp", "embed")),
        "b_down": spec((d,), ("act_embed",), init="zeros"),
    }
    return {
        "frame_proj": spec((cfg.frontend_dim, d), ("frames", "embed")),
        "layers": stack_layers({"attn": blocks.attn_specs(cfg), "ffn": ffn}, cfg.num_layers),
        "final_ln": spec((d,), ("act_embed",), init="zeros"),
        "head": spec((d, cfg.vocab), ("embed", "vocab")),
    }


def _hybrid_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX ``HybridLM.param_specs()`` (zamba2): the Mamba2 blocks
    stacked ``[groups, shared_block_every, ...]`` and one shared attention
    block and MLP, called after every group."""
    from repro_torch.models import blocks, ssd

    every = cfg.ssm.shared_block_every
    return {
        "embed": spec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        "groups": stack_layers(stack_layers(ssd.ssd_specs(cfg), every), cfg.num_layers // every),
        "shared_attn": blocks.attn_specs(cfg),
        "shared_mlp": blocks.mlp_specs(cfg),
        "final_ln": spec((cfg.d_model,), ("act_embed",), init="zeros"),
        "head": spec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def _xlstm_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX ``XLSTMLM.param_specs()`` (xlstm-350m): ``slstm_every``
    blocks a pair, the mLSTM blocks stacked ``[pairs, slstm_every - 1,
    ...]`` and the one sLSTM block ``[pairs, ...]``."""
    from repro_torch.models import xlstm_blocks

    every = cfg.xlstm.slstm_every
    pairs = cfg.num_layers // every
    return {
        "embed": spec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        "pairs": {
            "mlstm": stack_layers(stack_layers(xlstm_blocks.mlstm_specs(cfg), every - 1), pairs),
            "slstm": stack_layers(xlstm_blocks.slstm_specs(cfg), pairs),
        },
        "final_ln": spec((cfg.d_model,), ("act_embed",), init="zeros"),
        "head": spec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The tree of :class:`ParamSpec` of ``cfg``'s model (the decoder's, an
    encoder-only config's encoder, a hybrid config's ``HybridLM``, an SSM
    config's ``XLSTMLM``), as the JAX model's ``param_specs()``."""
    if cfg.encoder_only:
        return _encoder_tree(cfg)
    if cfg.family == HYBRID:
        return _hybrid_tree(cfg)
    if cfg.family == SSM:
        return _xlstm_tree(cfg)
    return _decoder_tree(cfg)


def decoder_specs(cfg: ModelConfig) -> List[Tuple[str, ParamSpec]]:
    """``(name, spec)`` of every parameter of ``cfg``'s model, in
    registration order."""
    return named_specs(param_specs(cfg))


def decoder_shapes(cfg: ModelConfig) -> List[Tuple[str, Shape]]:
    """``(name, shape)`` of every parameter of ``cfg``'s model, in
    registration order."""
    return [(n, p.shape) for n, p in decoder_specs(cfg)]


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
    on the same device). As ``init_tree``: a tensor whose spec's ``init`` is
    ``"zeros"`` or ``"ones"`` is that, every other one normal with std
    ``scale / sqrt(fan_in)`` (``fan_in`` the second-to-last dimension),
    drawn in f32 and cast to ``dtype``. A stacked tensor is drawn one matrix
    at a time (a layer's, or a layer's expert's), so the f32 temporary is
    one matrix's, not the whole stack's: dbrx's ``w_gate`` at 4 layers
    would be a 17 GB f32 temporary."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, p in decoder_specs(cfg):
        shape = p.shape
        t = torch.zeros(shape, dtype=dtype, device=dev)
        if p.init == "ones":
            t.fill_(1)
        elif p.init == "normal":
            fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
            std = p.scale / np.sqrt(fan_in)
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
