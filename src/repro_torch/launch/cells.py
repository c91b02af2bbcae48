"""Dry-run cells: (arch x shape x mesh) -> a step function and its
per-device inputs, placed on a ``DeviceMesh``; the port's counterpart of
the JAX package's ``launch/cells.py``.

Shared by :mod:`repro_torch.launch.dryrun` (the trace and its counts) and
``chip_smoke.py`` (the same cells at world 1 on the card). Nothing is
allocated: every input is a fake tensor (``FakeTensorMode``) of a rank's
own block, made inside the mode and wrapped as a DTensor placed by the
rules (:func:`repro_torch.sharding.place_new`), the counterpart of the JAX
cell's ``ShapeDtypeStruct`` and ``NamedSharding``. The step runs outside
the mode: its fake tensors carry their mode with them, and DTensor's
sharding propagation, which builds small index tensors of its own and
reads them back, would find those fake too.

The inputs, leaf for leaf the JAX cell's:

* parameters in ``param_dtype`` (bf16) under the kind's rules
  (``rules_for``: ``TRAIN_RULES``, ``SERVE_RULES``, or ``LONG_SERVE_RULES``
  at batch 1), and a train step's AdamW moments in ``opt_state_dtype``
  (f32) placed as the parameters;
* the batch by ``_INPUT_AXES``: tokens ``[B, S]`` (int64, the port's token
  dtype where the JAX cell's is int32: ``torch.gather`` of the loss takes
  int64), a VLM's patches ``[B, P, d_model]`` and tokens ``[B, S - P]``,
  an encoder's frames, targets and mask;
* a decode step's cache of ``cache_specs(B, seq_len)`` in bf16
  (``_cache_dtype``; f32 for the hybrid and SSM families' states) and
  ``tokens [B, 1]`` at ``cache_len = seq_len - 1`` (the JAX cell traces
  its length as a scalar; the port's decode takes the integer, the last
  slot's position);
* outputs placed as the JAX cell's ``out_shardings``: a prefill's and a
  decode's logits of the last position ``[B, 1, vocab]`` by ``("batch",
  None, "vocab")`` and the cache by its specs; a train step returns its
  inputs, written in place.

The model takes the attention through the kernel operators
(``flash_attention_op``, ``mla_decode_op``): their fakes run no attention
and their FLOP formulas count the kernels' work. The main path's defaults
stay the wrappers; both reach the same kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import AUDIO, HYBRID, SSM, VLM, ModelConfig, ShapeCase
from repro_torch.models.params import ParamSpec, spec

#: logical axes of the batch inputs, by key
_INPUT_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "targets": ("batch", "seq"),
    "mask": ("batch", "seq"),
    "frames": ("batch", "seq", None),
    "patches": ("batch", None, "act_embed"),
}


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    case: ShapeCase
    step_fn: Callable
    in_structs: Tuple[Any, ...]
    kind: str  # "train" | "prefill" | "decode"
    opt: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: each output's placements (None: as the step leaves it), the JAX
    #: cell's ``out_shardings``
    out_placements: Any = None

    def trace(self, mesh: Any, *, memory: bool = False) -> Dict[str, Any]:
        """Run the step on its inputs under the counting mode of
        :mod:`repro_torch.launch.op_costs` and the optimisation flags
        (``optim.optimizations(mesh=mesh, **opt)``), its outputs placed as
        ``out_placements``. Returns ``{"costs", "argument_bytes",
        "output_bytes"}``: the per-device counts and this rank's bytes of
        the inputs' and the outputs' blocks; with ``memory``, also
        ``"temp_bytes"``, the peak of what the step allocates on this rank
        beside its inputs (``torch.distributed._tools.mem_tracker``, which
        follows fake tensors as real ones)."""
        import contextlib

        from repro_torch.launch import op_costs
        from repro_torch.models import optim

        def run(*args):
            return _placed(self.step_fn(*args), self.out_placements)

        tracker = None
        if memory:
            from torch.distributed._tools.mem_tracker import MemTracker

            tracker = MemTracker()
        with optim.optimizations(mesh=mesh, **self.opt), tracker or contextlib.nullcontext():
            costs, out = op_costs.count(run, *self.in_structs)
        rec = {"costs": costs, "argument_bytes": local_bytes(self.in_structs), "output_bytes": local_bytes(out)}
        if tracker is not None:
            rec["temp_bytes"] = sum(int(by["Total"]) for by in tracker.get_tracker_snapshot("peak").values())
        return rec


def _placed(out: Any, placements: Any) -> Any:
    """``out`` with each DTensor redistributed to the placements of the
    same place in ``placements`` (a tree of tuples and None)."""
    from repro_torch.models.optim import is_dtensor

    if placements is None:
        return out
    if is_dtensor(out):
        return out if tuple(out.placements) == tuple(placements) else out.redistribute(out.device_mesh, placements)
    if isinstance(out, dict):
        return {k: _placed(v, placements.get(k)) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_placed(v, p) for v, p in zip(out, placements))
    return out


def local_bytes(tree: Any) -> int:
    """This rank's bytes of every tensor in a tree (a DTensor's local
    block)."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.models.optim import is_dtensor

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def _cache_dtype(cfg: ModelConfig) -> torch.dtype:
    # decoder KV caches in bf16; recurrent/SSM states stay f32
    return torch.float32 if cfg.family in (HYBRID, SSM) else torch.bfloat16


def input_specs(cfg: ModelConfig, case: ShapeCase) -> Dict[str, Tuple[ParamSpec, torch.dtype]]:
    """The batch of a step of ``case``, as the JAX model's
    ``input_specs``: each input's spec (shape, ``_INPUT_AXES``) and dtype."""
    b, s = case.global_batch, case.seq_len

    def leaf(name, shape, dtype):
        return spec(shape, _INPUT_AXES[name][: len(shape)]), dtype

    if cfg.encoder_only:
        return {"frames": leaf("frames", (b, s, cfg.frontend_dim), torch.bfloat16),
                "targets": leaf("targets", (b, s), torch.int64), "mask": leaf("mask", (b, s), torch.bool)}
    if cfg.family == VLM:
        p = cfg.num_patches
        return {"tokens": leaf("tokens", (b, s - p), torch.int64),
                "patches": leaf("patches", (b, p, cfg.d_model), torch.bfloat16)}
    return {"tokens": leaf("tokens", (b, s), torch.int64)}


def _model(cfg: ModelConfig):
    """The model with its attention through the kernel operators."""
    from repro_torch.kernels.flash_attention import flash_attention_op
    from repro_torch.kernels.mla_decode import mla_decode_op
    from repro_torch.models import build_model

    if cfg.family == SSM:
        return build_model(cfg)
    if cfg.family in (AUDIO, HYBRID):
        return build_model(cfg, attention=flash_attention_op)
    return build_model(cfg, attention=flash_attention_op, latent_attention=mla_decode_op)


def seq_period(cfg: ModelConfig, case: ShapeCase) -> Optional[int]:
    """The tokens of one repeat of the cell's work along its sequence,
    where its counts grow exactly linearly with the length (the model's
    ``seq_period``: an xLSTM's train and prefill steps, one mLSTM chunk),
    else None."""
    period = getattr(_model(cfg), "seq_period", None)
    return None if period is None else period(case.kind)


def build_cell(
    arch: str,
    shape: str,
    mesh: Any,
    *,
    param_dtype: torch.dtype = torch.bfloat16,
    opt_state_dtype: torch.dtype = torch.float32,
    rules: Optional[Any] = None,
    opt: Optional[Dict[str, Any]] = None,
    layers: Optional[int] = None,
    cfg: Optional[ModelConfig] = None,
    case: Optional[ShapeCase] = None,
) -> Cell:
    """The cell of ``arch`` x ``shape`` on the ``DeviceMesh`` ``mesh``
    (see the module docstring). ``layers`` cuts the depth (the trip-count
    extension of :func:`repro_torch.launch.op_costs.analyze_cell`);
    ``cfg`` replaces the registry's config (a narrowed one, in tests) and
    ``case`` the shape's (a batch cut to one card's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.sharding import place_new, rules_for, sharding_for, tree_shardings
    from repro_torch.models.params import decoder_specs
    from repro_torch.training import AdamW, AdamWState, make_decode_step, make_prefill_step, make_train_step

    cfg = cfg or get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    case = case or SHAPES[shape]
    model = _model(cfg)
    rules = rules or rules_for(case.kind, global_batch=case.global_batch)
    opt = opt or {}
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    device = mesh.device_type

    def placed(specs, dtype):
        """Fake blocks, made inside the mode (their placements and shapes
        are worked out outside it: DTensor reads its offsets back)."""
        def block(shape):
            with fake:
                return torch.empty(shape, dtype=dtype, device=device)

        return place_new(specs, rules, mesh, block)

    pspecs = dict(decoder_specs(cfg))
    params = placed(pspecs, param_dtype)
    batch = {n: placed(sp, dt) for n, (sp, dt) in input_specs(cfg, case).items()}

    if case.kind == "train":
        optimizer = AdamW(state_dtype=opt_state_dtype)
        step = make_train_step(model, cfg, optimizer)
        state = AdamWState(0, placed(pspecs, opt_state_dtype), placed(pspecs, opt_state_dtype))
        return Cell(arch, shape, cfg, case, step, (params, state, batch), "train", opt=opt)

    def logits_placements():
        b = case.global_batch
        return sharding_for(spec((b, 1, cfg.vocab), ("batch", None, "vocab")), rules, mesh)

    if case.kind == "prefill" or cfg.encoder_only:
        if cfg.encoder_only:
            # encoder "prefill" = full encode (logits only)
            def encode_step(params, batch):
                return model.forward(params, batch)

            return Cell(arch, shape, cfg, case, encode_step, (params, batch), "prefill", opt=opt)
        cache_pl = tree_shardings(model.cache_specs(case.global_batch, case.seq_len), rules, mesh)
        return Cell(arch, shape, cfg, case, make_prefill_step(model), (params, batch), "prefill", opt=opt,
                    out_placements=(logits_placements(), cache_pl, None))

    # decode: one new token against a cache of seq_len slots, at its last
    ring = case.name == "long_500k" and cfg.family == HYBRID
    cspecs = model.cache_specs(case.global_batch, case.seq_len, ring=ring)
    cache = placed(cspecs, _cache_dtype(cfg))
    tokens = placed(spec((case.global_batch, 1), ("batch", None)), torch.int64)
    return Cell(arch, shape, cfg, case, make_decode_step(model, ring=ring), (params, cache, tokens, case.seq_len - 1),
                "decode", opt=opt, out_placements=(logits_placements(), tree_shardings(cspecs, rules, mesh)))


def live_cells() -> Tuple[Tuple[str, str], ...]:
    """All live (arch, shape) pairs per the DESIGN.md skip table."""
    from repro_torch.configs import ARCH_IDS, live_shapes

    out = []
    for arch in ARCH_IDS:
        for shape in live_shapes(get_config(arch)):
            out.append((arch, shape))
    return tuple(out)
