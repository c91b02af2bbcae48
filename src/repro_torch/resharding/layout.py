"""Replica shard layouts, assembled from per-shard manifests.

A :class:`ReplicaLayout` is the planner's view of one replica: for every
tensor, the global shape plus each shard's slice (see the package
docstring for the descriptor format). It also records which transfer unit
carries the tensor in each shard's manifest — the planner annotates every
read interval with that unit index so pipelined readers can gate on the
source's per-unit progress counter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.core.errors import ShardLayoutError
from repro_torch.core.meta import ShardManifest, TensorMeta, dtype_from_str


def dtype_itemsize(name: str) -> int:
    """Itemsize of a numpy-style dtype string, from the port's torch
    dtype table."""
    return dtype_from_str(name).itemsize


@dataclasses.dataclass(frozen=True)
class ShardSlice:
    """One shard's block of one tensor, in global coordinates."""

    shard: int
    start: Tuple[int, ...]
    shape: Tuple[int, ...]
    #: index of the TransferUnit carrying this tensor in the shard manifest
    unit: int
    #: byte offset of this tensor's payload inside the carrying unit
    #: (0 for a plain unit; the member offset for a compacted bucket)
    unit_offset: int = 0
    #: total payload bytes of the carrying unit (0 when unknown)
    unit_nbytes: int = 0
    #: element dtype of the carrying unit's payload as seen by wire
    #: codecs (``None`` for mixed-dtype buckets — codecs pass through)
    unit_dtype: Optional[str] = None

    @property
    def stop(self) -> Tuple[int, ...]:
        return tuple(s + n for s, n in zip(self.start, self.shape))


@dataclasses.dataclass(frozen=True)
class TensorLayout:
    """All shards' slices of one tensor."""

    name: str
    dtype: str
    itemsize: int
    global_shape: Tuple[int, ...]
    slices: Tuple[ShardSlice, ...]

    @property
    def global_nbytes(self) -> int:
        n = self.itemsize
        for d in self.global_shape:
            n *= d
        return n

    def slice_for(self, shard: int) -> Optional[ShardSlice]:
        for s in self.slices:
            if s.shard == shard:
                return s
        return None


@dataclasses.dataclass(frozen=True)
class ReplicaLayout:
    """Planner's view of one replica: tensors in manifest order."""

    num_shards: int
    tensors: Tuple[TensorLayout, ...]

    def tensor(self, name: str) -> Optional[TensorLayout]:
        for t in self.tensors:
            if t.name == name:
                return t
        return None

    def names(self) -> List[str]:
        return [t.name for t in self.tensors]


def _unit_placement(
    manifest: ShardManifest, tensor: str
) -> Tuple[int, int, int]:
    """Where a tensor's bytes live in the shard's unit schema:
    ``(unit_index, byte_offset_in_unit, unit_nbytes)``."""
    for u in manifest.units:
        if u.name == tensor:
            return u.index, 0, u.nbytes
        if tensor in u.members:
            for name, off, _nb in u.layout:
                if name == tensor:
                    return u.index, off, u.nbytes
            raise ShardLayoutError(
                f"tensor {tensor!r}: compacted bucket {u.name!r} has no "
                "layout entry for it (cannot place unit-space reads)"
            )
    raise ShardLayoutError(f"tensor {tensor!r} not carried by any transfer unit")


def layout_from_manifests(
    manifests: Mapping[int, ShardManifest], num_shards: Optional[int] = None
) -> ReplicaLayout:
    """Assemble a :class:`ReplicaLayout` from per-shard manifests.

    ``manifests`` may be partial (a destination planning only its own
    shard passes just that one); ``num_shards`` defaults to the number of
    manifests provided.
    """
    from repro_torch.transfer.codec import unit_wire_dtype

    if not manifests:
        raise ShardLayoutError("no manifests to build a layout from")
    n = len(manifests) if num_shards is None else num_shards
    by_name: Dict[str, List[ShardSlice]] = {}
    meta_by_name: Dict[str, TensorMeta] = {}
    order: List[str] = []
    for shard, manifest in sorted(manifests.items()):
        tensor_map = {t.name: t for t in manifest.tensors}
        unit_dtypes = {
            u.index: unit_wire_dtype(tensor_map, u) for u in manifest.units
        }
        for meta in manifest.tensors:
            gshape = meta.global_shape or meta.shape
            prev = meta_by_name.get(meta.name)
            if prev is None:
                meta_by_name[meta.name] = meta
                order.append(meta.name)
            else:
                prev_g = prev.global_shape or prev.shape
                if prev_g != gshape or prev.dtype != meta.dtype:
                    raise ShardLayoutError(
                        f"tensor {meta.name!r}: shards disagree on global "
                        f"shape/dtype ({prev_g}/{prev.dtype} vs "
                        f"{gshape}/{meta.dtype})"
                    )
            unit, unit_off, unit_nbytes = _unit_placement(manifest, meta.name)
            by_name[meta.name] = by_name.get(meta.name, [])
            by_name[meta.name].append(
                ShardSlice(
                    shard=shard,
                    start=meta.start,
                    shape=meta.shape,
                    unit=unit,
                    unit_offset=unit_off,
                    unit_nbytes=unit_nbytes,
                    unit_dtype=unit_dtypes[unit],
                )
            )
    tensors = tuple(
        TensorLayout(
            name=name,
            dtype=meta_by_name[name].dtype,
            itemsize=dtype_itemsize(meta_by_name[name].dtype),
            global_shape=meta_by_name[name].global_shape or meta_by_name[name].shape,
            slices=tuple(by_name[name]),
        )
        for name in order
    )
    return ReplicaLayout(num_shards=n, tensors=tensors)


# ---------------------------------------------------------------------------
# Tensor-parallel splitting helper (tests, examples, benchmarks)
# ---------------------------------------------------------------------------


def tp_axis_for(name: str, shape: Tuple[int, ...], num_shards: int) -> Optional[int]:
    """Default TP rule: shard the first dim divisible by ``num_shards``
    (row parallelism); tensors with no divisible dim stay replicated."""
    for axis, d in enumerate(shape):
        if d % num_shards == 0 and d >= num_shards:
            return axis
    return None


def tp_shard(
    global_tensors: Mapping[str, torch.Tensor],
    shard_idx: int,
    num_shards: int,
    *,
    axis_overrides: Optional[Mapping[str, Optional[int]]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]]:
    """Slice global tensors for one TP shard.

    Returns ``(local_tensors, layout)`` where ``layout`` maps tensor name
    to ``(global_shape, offset)`` — the arguments
    :meth:`repro_torch.transfer.engine.WorkerStore.register` takes to stamp
    the layout descriptor onto the registered buffers. Tensors whose shard
    axis is ``None`` (no divisible dim, or overridden) are replicated.
    Each local block is contiguous, on the global tensor's device (a view
    of it where the slice already is contiguous, as in NumPy).
    """
    locals_: Dict[str, torch.Tensor] = {}
    layout: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {}
    for name, arr in global_tensors.items():
        gshape = tuple(arr.shape)
        if axis_overrides is not None and name in axis_overrides:
            axis = axis_overrides[name]
        else:
            axis = tp_axis_for(name, gshape, num_shards)
        if axis is None:
            locals_[name] = arr.contiguous()
            layout[name] = (gshape, (0,) * arr.ndim)
            continue
        per = gshape[axis] // num_shards
        sel = [slice(None)] * arr.ndim
        sel[axis] = slice(shard_idx * per, (shard_idx + 1) * per)
        offset = [0] * arr.ndim
        offset[axis] = shard_idx * per
        locals_[name] = arr[tuple(sel)].contiguous()
        layout[name] = (gshape, tuple(offset))
    return locals_, layout
