"""Per-device costs of a step, counted from the ops each rank runs: the
port's counterpart of the JAX package's ``launch/hlo_analyzer.py``.

The JAX analyzer reads the per-device SPMD program XLA compiled. The port
runs eagerly, so its per-device program is the stream of ops each rank's
local tensors go through. :func:`analyze` runs a function under a
``TorchDispatchMode`` that lets DTensor desugar every op on DTensors first
(returning ``NotImplemented`` to it, as ``CommDebugMode`` does) and so
sees, for each op, the local blocks it runs on and the c10d collectives
that DTensor's redistributions issue. It never counts a DTensor-level op
at its global shape. Over those ops:

* **dot FLOPs**: every op with a formula in ``torch.utils.flop_counter``'s
  registry, at its local shapes: ``mm``, ``addmm``, ``bmm`` and
  ``baddbmm`` (and what ``matmul`` and ``einsum`` lower to) at ``2
  numel(out) K``, and the kernel operators ``repro_torch::flash_attention``
  (with its backward) and ``repro_torch::mla_decode`` by their own
  formulas: the live pairs the kernels compute, not what the calls would
  decompose into;
* **HBM bytes**: the bytes of the distinct tensors each op reads and
  writes, its operands and its results, counted once each (an in-place
  op's result is its operand; a slot write is its source read and its
  slot written). Views, ``detach``, allocation without a write and the
  collectives' waits are free. The eager port fuses nothing, so this is
  its own traffic, not a fused program's;
* **collectives** by the JAX module's five kinds: the c10d functional ops
  (``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``,
  ``all_to_all_single``) and the c10d ops a ``torch.distributed`` call
  issues (H3's ``all_reduce``, ``global_norm``'s), each by its per-rank
  result bytes, and those bytes again by the slowest link its process
  group crosses (:func:`repro_torch.launch.roofline.link_of`).

In a trace of fake tensors only ops that touch a fake tensor of the
inputs' fake mode count: the ops DTensor runs on small real index tensors
for its own bookkeeping, and on fake tensors of its own mode to learn an
op's output shape (once an op, then cached), are not the device's work.
In a run of real tensors only ops that touch a real tensor on the inputs'
device count.

Trip counts, the JAX analyzer's ``_trip_count``: the port's layers are a
Python loop, so a full-depth trace does every layer's work. The counts of
a step grow by the same amount with each layer pattern (gemma2's
local/global pair; past a MoE model's dense prefix) once DTensor's
placements of the residual stream have settled (the embedding, the head
and the stacked parameters' gradient collectives are counted once,
whatever the depth), so :func:`analyze_cell` traces a cell at cut depths
one pattern apart until two successive patterns add the same counts and
extends that increment to the config's depth, exactly: the tests hold it
to a full-depth trace.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import HYBRID
from repro_torch.launch.roofline import COLLECTIVES, LINK_RATES, link_of

#: the c10d ops by the JAX module's collective kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}
#: c10d ops that move nothing: a wait, a barrier, autograd's wrapper
_C10D_FREE = {"wait_tensor", "_wrap_tensor_autograd", "barrier", "monitored_barrier_"}
#: ops that allocate without writing, or only describe or view a tensor
#: (``_unsafe_view``: the view a reshape takes of its own copy)
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach", "alias", "lift_fresh",
         "_unsafe_view", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "device", "_local_scalar_dense"}


@dataclasses.dataclass
class OpCosts:
    """The JAX ``HloCosts`` fields, per device, in integers (sums of them
    stay exact), and the collectives' bytes by link."""

    dot_flops: int = 0
    hbm_bytes: int = 0
    collective_bytes: Dict[str, int] = dataclasses.field(default_factory=lambda: {k: 0 for k in COLLECTIVES})
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=lambda: {k: 0 for k in COLLECTIVES})
    collective_bytes_by_link: Dict[str, int] = dataclasses.field(default_factory=lambda: {k: 0 for k in LINK_RATES})

    @property
    def total_collective_bytes(self) -> int:
        return sum(self.collective_bytes.values())

    def extended(self, deeper: "OpCosts", times: int) -> "OpCosts":
        """These counts plus ``times`` the difference ``deeper - self``:
        the counts of a step ``times`` more layer patterns deep."""
        def ext(a, b):
            return a + times * (b - a)

        def ext_map(a, b):
            return {k: ext(a[k], b[k]) for k in a}

        return OpCosts(ext(self.dot_flops, deeper.dot_flops), ext(self.hbm_bytes, deeper.hbm_bytes),
                       ext_map(self.collective_bytes, deeper.collective_bytes),
                       ext_map(self.collective_counts, deeper.collective_counts),
                       ext_map(self.collective_bytes_by_link, deeper.collective_bytes_by_link))

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t: Any) -> bool:
    return isinstance(t, FakeTensor)


def _local(t: Any) -> Any:
    """A DTensor's local block, anything else as it is."""
    from repro_torch.models.optim import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def _group_ranks(args) -> Optional[Tuple[int, ...]]:
    """The global ranks of a c10d op's process group: a functional
    collective names it, a ``torch.distributed`` call passes it."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return tuple(dist.get_process_group_ranks(_resolve_process_group(a)))
            except (ValueError, RuntimeError, KeyError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return tuple(dist.get_process_group_ranks(a))
    return None


class OpCounter(TorchDispatchMode):
    """The counting mode (see the module docstring). With ``fake_mode``
    it counts the ops that touch a fake tensor of that mode, else those
    that touch a real tensor on ``device``: DTensor's sharding propagation
    runs each new op once on fake tensors of a mode of its own to learn
    its output's shape, which is no work of the step's."""

    def __init__(self, *, fake_mode: Any = None, device: Optional[torch.device] = None):
        super().__init__()
        self.fake_mode = fake_mode
        self.device = device
        self.costs = OpCosts()

    def _counts(self, tensors) -> bool:
        if self.fake_mode is not None:
            return any(_is_fake(t) and t.fake_mode is self.fake_mode for t in tensors)
        return any(not _is_fake(t) and t.device == self.device for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars it into local ops and collectives, which come back here
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload) or (self.fake_mode is not None and FakeTensor not in types):
            return out
        tensors = [t for t in tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor)]
        if not tensors or not self._counts(tensors):
            return out
        name = func._schema.name.split("::")[-1]
        if func.namespace in ("_c10d_functional", "c10d"):
            if name in _C10D_FREE:
                return out
            kind = _KINDS.get(name)
            if kind is None:
                raise NotImplementedError(f"op_costs: collective {func} has no kind")
            results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            nbytes = sum(_nbytes(t) for t in results)
            ranks = _group_ranks(list(args) + list(kwargs.values()))
            c = self.costs
            c.collective_counts[kind] += 1
            c.collective_bytes[kind] += nbytes
            c.collective_bytes_by_link[link_of(ranks) if ranks else "nvlink"] += nbytes
            c.hbm_bytes += sum(_nbytes(t) for t in {id(t): t for t in tensors}.values())
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.costs.dot_flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view or name in _FREE:
            return out
        self.costs.hbm_bytes += sum(_nbytes(t) for t in {id(t): t for t in tensors}.values())
        return out


def _trace_kind(args) -> Tuple[Any, Optional[torch.device]]:
    """The fake mode of ``args``' fake tensors (a dry run), else None and
    their device."""
    leaves = [_local(t) for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    for t in leaves:
        if _is_fake(t):
            return t.fake_mode, None
    return None, (leaves[0].device if leaves else torch.device("cpu"))


def count(fn: Callable, *args, **kwargs) -> Tuple[OpCosts, Any]:
    """``(costs, fn(*args, **kwargs))``: the per-device counts of the call
    and what it returned."""
    fake_mode, device = _trace_kind((args, kwargs))
    counter = OpCounter(fake_mode=fake_mode, device=device)
    with counter:
        out = fn(*args, **kwargs)
    return counter.costs, out


def analyze(fn: Callable, *args, **kwargs) -> OpCosts:
    """The per-device costs of ``fn(*args, **kwargs)`` (the module
    docstring): of fake tensors (nothing computed, nothing allocated) or
    of real ones, plain or DTensors."""
    return count(fn, *args, **kwargs)[0]


def layer_pattern(cfg) -> Tuple[int, int]:
    """``(prefix, period)`` of a config's layers: the dense layers before
    the stacked ones (a MoE model's ``first_dense``) and the layers of one
    repeat of the stack (gemma2's local/global pair, a hybrid's group of
    Mamba2 blocks and its shared block, an xLSTM's mLSTM/sLSTM pair, else
    one)."""
    prefix = cfg.moe.first_dense if cfg.moe is not None else 0
    if cfg.ssm is not None and cfg.family == HYBRID:
        return prefix, cfg.ssm.shared_block_every
    if cfg.xlstm is not None:
        return prefix, cfg.xlstm.slstm_every
    return prefix, (2 if cfg.alt_local_global else 1)


#: layer patterns :func:`analyze_cell` traces at most before it gives up
#: on finding two equal increments
MAX_PATTERNS = 8


def first_depth(cfg) -> int:
    """The shallowest depth :func:`analyze_cell` traces: the dense prefix
    and one layer pattern."""
    prefix, period = layer_pattern(cfg)
    return prefix + period


def analyze_cell(arch: str, shape: str, mesh: Any, *, cfg=None, memory: bool = False, **kw) -> Dict[str, Any]:
    """A dry-run cell's per-device counts at its config's full depth, from
    traces of cut depths (the module docstring).

    The placements DTensor gives the residual stream may change over the
    first layers (each layer's ops take the placements the last one left:
    nothing pins them, where XLA's scan runs every layer as one body), and
    with them the collectives a layer issues. So the cell is traced at
    :func:`first_depth` and then one layer pattern deeper at a time until
    two successive patterns add the same counts, every field exactly; the
    last of those increments is then extended to the config's depth
    (:meth:`OpCosts.extended`). A config no deeper than the traces is
    traced at its own depth. ``cfg`` overrides the registry's config (a
    narrowed one, in tests); ``memory`` and ``kw`` go to
    :meth:`repro_torch.launch.cells.Cell.trace` and
    :func:`repro_torch.launch.cells.build_cell`. Returns ``{"costs",
    "depths", "times", "trace_s"}``, the counts, the depths traced, the
    patterns the last two were extended by and the traces' seconds, beside
    the traces' byte records (``argument_bytes``, ``output_bytes``, with
    ``memory`` ``temp_bytes``) extended the same way."""
    import time

    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell

    cfg = cfg or get_config(arch)
    _, period = layer_pattern(cfg)
    depths, traced, seconds = [], [], []

    def trace(depth: int) -> None:
        t0 = time.perf_counter()
        traced.append(build_cell(arch, shape, mesh, cfg=cfg, layers=depth, **kw).trace(mesh, memory=memory))
        seconds.append(time.perf_counter() - t0)
        depths.append(depth)

    def result(times: int) -> Dict[str, Any]:
        if not times:
            out = dict(traced[-1])
        else:
            a, b = traced[-2], traced[-1]
            out = {k: (a[k].extended(b[k], times) if k == "costs" else a[k] + times * (b[k] - a[k])) for k in a}
        return dict(out, depths=depths, times=times, trace_s=seconds)

    depth = first_depth(cfg)
    if (cfg.num_layers - depth) % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not {depth} + a whole number of {period}")
    while True:
        if depth >= cfg.num_layers or len(depths) > MAX_PATTERNS:
            if depth < cfg.num_layers:
                raise RuntimeError(f"{arch} x {shape}: no two equal increments in {depths} layers")
            trace(cfg.num_layers)
            return result(0)
        trace(depth)
        costs = [r["costs"] for r in traced[-3:]]
        if len(costs) == 3 and _increment(costs[0], costs[1]) == _increment(costs[1], costs[2]):
            return result((cfg.num_layers - depths[-2]) // period)
        depth += period


def _increment(a: OpCosts, b: OpCosts) -> Dict[str, Any]:
    """Every field of ``b - a``."""
    da, db = a.as_dict(), b.as_dict()
    return {k: ({n: db[k][n] - v for n, v in da[k].items()} if isinstance(da[k], dict) else db[k] - da[k])
            for k in da}
