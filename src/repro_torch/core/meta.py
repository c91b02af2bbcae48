"""Shared metadata types for the ROS control plane and the transfer engine.

The reference server never touches weight bytes; it moves only the
lightweight descriptors defined here (3.1: "The server only operates on
lightweight references").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: Tensors smaller than this are compacted into contiguous buffers before
#: registration/transfer (4.3.2 "Tiny-Tensor Optimization").
TINY_TENSOR_BYTES = 2 * 1024 * 1024

#: Data-plane defaults shared by the threaded client, the simulator and
#: the server's scheduler: up to ``DEFAULT_WINDOW`` unit flows in flight
#: per destination shard (windowed pipelining), and units larger than
#: ``DEFAULT_CHUNK_BYTES`` split into byte-range reads. The chunk
#: threshold doubles as the scheduler's "giant unit" hint: workloads
#: whose units exceed it replicate badly over store-and-forward pipeline
#: chains (a relay can only serve *completed* units), so the scheduler
#: prefers partitioning them across fully-published replicas.
DEFAULT_WINDOW = 4
DEFAULT_CHUNK_BYTES = 1024 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """Descriptor of one named weight tensor held by a shard.

    ``shape`` is the *local* shape of the block this shard holds. The
    optional layout descriptor (``global_shape`` + ``offset``) places the
    local block inside the logical global tensor, enabling cross-layout
    resharding (``repro_torch.resharding``): a destination sharded differently
    from the source intersects its slice against every source shard's
    slice and stripes byte-interval reads across them.

    * ``global_shape is None`` — no layout metadata: the tensor is treated
      as unsharded/identical across layouts (convertible only if the peer
      holds a block of the same local shape).
    * ``offset`` — per-dim start of the local block in global coordinates;
      the slice held is ``[offset[d], offset[d] + shape[d])`` per dim d.
    """

    name: str
    shape: Tuple[int, ...]
    dtype: str  # numpy dtype string, e.g. "bfloat16", "float32"
    nbytes: int
    global_shape: Optional[Tuple[int, ...]] = None
    offset: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if self.nbytes < 0:
            raise ValueError(f"tensor {self.name}: negative nbytes")
        if self.global_shape is not None:
            off = self.offset or (0,) * len(self.global_shape)
            if len(off) != len(self.global_shape) or len(self.shape) != len(
                self.global_shape
            ):
                raise ValueError(f"tensor {self.name}: rank mismatch in layout")
            for o, n, g in zip(off, self.shape, self.global_shape):
                if o < 0 or o + n > g:
                    raise ValueError(
                        f"tensor {self.name}: slice [{o}, {o + n}) exceeds "
                        f"global dim {g}"
                    )

    @property
    def start(self) -> Tuple[int, ...]:
        """Slice start in global coordinates (zeros when unspecified)."""
        if self.offset is not None:
            return self.offset
        return (0,) * len(self.shape)

    @property
    def is_sharded(self) -> bool:
        return self.global_shape is not None and self.global_shape != self.shape


@dataclasses.dataclass(frozen=True)
class TransferUnit:
    """One unit of the data plane: a large tensor or a compacted bucket.

    The per-shard *progress counter* of pipeline replication (4.3.3) counts
    completed TransferUnits, in the deterministic order below. A partially
    replicated shard may serve exactly its prefix of units.
    """

    index: int
    name: str  # tensor name, or "__compact__/<i>" for a bucket
    nbytes: int
    #: member tensor names for a compacted bucket (empty for a plain tensor)
    members: Tuple[str, ...] = ()
    #: (name, offset, nbytes) layout of members inside the bucket
    layout: Tuple[Tuple[str, int, int], ...] = ()

    @property
    def is_compact(self) -> bool:
        return bool(self.members)


@dataclasses.dataclass(frozen=True)
class ShardManifest:
    """Everything a reader needs to pull one shard: ordered transfer units
    plus per-unit checksums. Attached to a publish() and stored (by
    reference) at the server."""

    tensors: Tuple[TensorMeta, ...]
    units: Tuple[TransferUnit, ...]
    checksums: Tuple[int, ...]  # per-unit; 0 when checksums disabled

    @property
    def total_bytes(self) -> int:
        return sum(u.nbytes for u in self.units)

    @property
    def num_units(self) -> int:
        return len(self.units)

    def validate_against(self, other: "ShardManifest") -> bool:
        """Shard-layout compatibility: same unit schema (names+sizes)."""
        if len(self.units) != len(other.units):
            return False
        return all(
            a.name == b.name and a.nbytes == b.nbytes and a.members == b.members
            for a, b in zip(self.units, other.units)
        )

    def same_layout(self, other: "ShardManifest") -> bool:
        """True when both shards hold byte-identical slices: same tensors,
        dtypes, local shapes AND layout descriptors. Two manifests can
        share a unit schema (validate_against) yet slice the global
        tensors along different axes — unit-for-unit copying between them
        would silently scramble weights; this is the check that gates the
        same-layout fast path."""
        theirs = {t.name: t for t in other.tensors}
        if len(self.tensors) != len(theirs):
            return False
        for a in self.tensors:
            b = theirs.get(a.name)
            if b is None:
                return False
            if (
                a.shape != b.shape
                or a.dtype != b.dtype
                or (a.global_shape or a.shape) != (b.global_shape or b.shape)
                or a.start != b.start
            ):
                return False
        return True


# ---------------------------------------------------------------------------
# Wire serialization (control-plane fault tolerance)
# ---------------------------------------------------------------------------
#
# The replayable op log and the failover snapshots need every control-plane
# record — op payloads (manifests, worker infos, version specs) and the
# server's own state dataclasses — in a JSON-able form. Rather than one
# hand-written encoder per type, a small generic codec walks registered
# dataclasses and the containers they nest (tuples, sets, dicts with tuple
# keys) and tags each non-JSON shape so the inverse is exact: a round trip
# through ``to_wire``/``from_wire`` reconstructs equal objects, and two
# equal object graphs encode to equal wire trees (the property the
# replay-equivalence tests compare on).

_WIRE_TYPES: Dict[str, type] = {}


def register_wire(cls: type) -> type:
    """Register a dataclass for wire encoding (usable as a decorator)."""
    _WIRE_TYPES[cls.__name__] = cls
    return cls


def to_wire(obj):
    """Encode ``obj`` into a JSON-able tree of dicts/lists/scalars."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    name = type(obj).__name__
    if dataclasses.is_dataclass(obj) and name in _WIRE_TYPES:
        return {
            "__dc__": name,
            "f": {
                f.name: to_wire(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
            },
        }
    if isinstance(obj, tuple):
        return {"__tuple__": [to_wire(x) for x in obj]}
    if isinstance(obj, list):
        return [to_wire(x) for x in obj]
    if isinstance(obj, (set, frozenset)):
        # canonical order so equal sets encode identically
        return {"__set__": sorted((to_wire(x) for x in obj), key=repr)}
    if isinstance(obj, dict):
        # pair list: keys may be tuples (layout families, txn keys)
        return {"__map__": [[to_wire(k), to_wire(v)] for k, v in obj.items()]}
    raise TypeError(f"not wire-serializable: {name}")


def from_wire(w):
    """Inverse of :func:`to_wire`."""
    if w is None or isinstance(w, (bool, int, float, str)):
        return w
    if isinstance(w, list):
        return [from_wire(x) for x in w]
    if "__dc__" in w:
        cls = _WIRE_TYPES.get(w["__dc__"])
        if cls is None:
            raise TypeError(f"unknown wire type {w['__dc__']!r}")
        return cls(**{k: from_wire(v) for k, v in w["f"].items()})
    if "__tuple__" in w:
        return tuple(from_wire(x) for x in w["__tuple__"])
    if "__set__" in w:
        return {from_wire(x) for x in w["__set__"]}
    if "__map__" in w:
        out = {}
        for k, v in w["__map__"]:
            key = from_wire(k)
            out[tuple(key) if isinstance(key, list) else key] = from_wire(v)
        return out
    raise TypeError(f"malformed wire value: {w!r}")


#: numpy-style dtype name -> (torch dtype, itemsize). ``TensorMeta.dtype``
#: keeps the numpy-style name ("bfloat16", never "torch.bfloat16") so
#: manifests compare equal to the JAX package's.
_DTYPES: Dict[str, Tuple[torch.dtype, int]] = {
    "float64": (torch.float64, 8),
    "float32": (torch.float32, 4),
    "bfloat16": (torch.bfloat16, 2),
    "float16": (torch.float16, 2),
    "int64": (torch.int64, 8),
    "int32": (torch.int32, 4),
    "int16": (torch.int16, 2),
    "int8": (torch.int8, 1),
    "uint8": (torch.uint8, 1),
    "bool": (torch.bool, 1),
}
_NAMES: Dict[torch.dtype, str] = {d: n for n, (d, _) in _DTYPES.items()}


def dtype_from_str(name: str) -> torch.dtype:
    """torch dtype from its numpy-style string name. Shared by the client
    and the codecs."""
    try:
        return _DTYPES[name][0]
    except KeyError:
        raise TypeError(f"unsupported dtype {name!r}") from None


def dtype_itemsize(name: str) -> int:
    """Bytes per element of a numpy-style dtype name."""
    try:
        return _DTYPES[name][1]
    except KeyError:
        raise TypeError(f"unsupported dtype {name!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """numpy-style name of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``), the form manifests carry."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype}") from None


def build_units(
    tensors: Sequence[TensorMeta],
    *,
    tiny_bytes: int = TINY_TENSOR_BYTES,
) -> List[TransferUnit]:
    """Compute the transfer-unit schedule for a shard.

    Large tensors become one unit each (registered directly with the NIC in
    RDMA-direct mode); tiny tensors are packed into contiguous buckets of up
    to ``tiny_bytes`` so that registration cost and per-message overhead are
    amortized. Order is registration order, which both sides share.
    """
    units: List[TransferUnit] = []
    bucket: List[TensorMeta] = []
    bucket_bytes = 0

    def flush_bucket() -> None:
        nonlocal bucket, bucket_bytes
        if not bucket:
            return
        layout = []
        off = 0
        for t in bucket:
            layout.append((t.name, off, t.nbytes))
            off += t.nbytes
        units.append(
            TransferUnit(
                index=len(units),
                name=f"__compact__/{len(units)}",
                nbytes=off,
                members=tuple(t.name for t in bucket),
                layout=tuple(layout),
            )
        )
        bucket = []
        bucket_bytes = 0

    for t in tensors:
        if t.nbytes < tiny_bytes:
            if bucket_bytes + t.nbytes > tiny_bytes and bucket:
                flush_bucket()
            bucket.append(t)
            bucket_bytes += t.nbytes
        else:
            units.append(TransferUnit(index=len(units), name=t.name, nbytes=t.nbytes))
    flush_bucket()
    # re-number: buckets were appended with provisional indices
    return [dataclasses.replace(u, index=i) for i, u in enumerate(units)]


@dataclasses.dataclass(frozen=True)
class WorkerInfo:
    """Placement of one shard-owning worker, used for topology-aware
    scheduling (4.3.1) and NIC affinity."""

    worker_id: str
    node: str
    datacenter: str
    is_spot: bool = False


# ---------------------------------------------------------------------------
# Read-plan metadata (shared by the server's scheduler and both data planes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SourceSlice:
    """One source replica's share of a destination's transfer-unit list.

    The multi-source scheduler partitions the destination's units
    ``[start_unit, stop_unit)`` across all eligible replicas holding the
    version; a ``stop_unit`` of ``-1`` means "through the last unit"
    (emitted when the server does not know the destination's unit count).

    ``ceiling`` is the source's *progress ceiling* at plan time (swarm
    replication): the number of units of its completed prefix, i.e. the
    most a reader may pull from it without re-checking progress. ``-1``
    means the source was fully published when the plan was built. A
    partial (in-progress) source serves exactly ``[0, ceiling)``; reads
    beyond it must first await the source's live progress counter — the
    never-read-past-source-prefix contract both data planes enforce.

    ``codec`` is the wire codec the server negotiated for this link
    (``repro_torch.transfer.codec``): WAN-crossing slices default to ``int8``,
    intra-DC (and all resharded interval reads) stay ``raw``. Both data
    planes honor it — the threaded transport encodes/decodes real bytes,
    the simulator derives fluid wire bytes from the codec's ratio."""

    source: str
    source_kind: str
    transport: str  # "rdma" | "tcp"
    start_unit: int
    stop_unit: int
    seeding: bool = False
    source_shards: int = 0
    ceiling: int = -1
    codec: str = "raw"

    def serves_whole_range(self) -> bool:
        """True when the plan-time prefix already covers the assigned
        range (no progress gating needed for any unit in it)."""
        return self.ceiling < 0 or self.stop_unit <= self.ceiling


for _cls in (TensorMeta, TransferUnit, ShardManifest, WorkerInfo, SourceSlice):
    register_wire(_cls)


@register_wire
@dataclasses.dataclass(frozen=True)
class Assignment:
    """Where a shard should pull its data from.

    ``source_shards``/``dest_shards`` carry the two replicas' shard
    layouts; when they differ the destination runs the cross-layout
    resharding path (``repro_torch.resharding``): every destination shard
    stripes byte-interval reads across *all* source shards instead of the
    shard-to-shard unit pipe. Zero means "unknown" (legacy constructors)
    and is treated as same-layout.

    ``sources`` is the multi-source read plan: per-source unit ranges
    partitioned over every eligible replica holding the version —
    including, under swarm replication, *in-progress* replicas serving
    their completed prefix (each slice's ``ceiling``). The legacy
    single-source fields (``source``/``transport``/...) always describe
    the *primary* source — ``sources[0]`` when a plan exists. ``epoch``
    identifies the plan revision; the server bumps it on re-partitioning
    (source failure, work stealing, swarm growth) and readers compare it
    against ``ReferenceServer.assignment_epoch`` to pick up the new plan
    mid-transfer.
    """

    version: int
    source: str
    source_kind: str
    transport: str  # "rdma" | "tcp"
    seeding: bool = False  # dest becomes its DC's seeding replica
    source_shards: int = 0
    dest_shards: int = 0
    sources: Tuple[SourceSlice, ...] = ()
    epoch: int = 0
    #: wire codec of the *primary* source link (``sources[0].codec`` when
    #: a plan exists); legacy single-source pulls read it directly
    codec: str = "raw"

    @property
    def resharded(self) -> bool:
        return (
            self.source_shards > 0
            and self.dest_shards > 0
            and self.source_shards != self.dest_shards
        )

    @property
    def multi_source(self) -> bool:
        return len(self.sources) > 1

    @property
    def swarm(self) -> bool:
        """True when any plan member was serving a partial prefix."""
        return any(s.ceiling >= 0 for s in self.sources)

    def slices(self, num_units: int) -> List[SourceSlice]:
        """Normalized per-source unit ranges: legacy single-source
        assignments expand to one slice spanning every unit, and
        open-ended ranges are clamped to ``num_units``."""
        if self.sources:
            return [
                dataclasses.replace(
                    s,
                    stop_unit=num_units if s.stop_unit < 0 else min(s.stop_unit, num_units),
                )
                for s in self.sources
            ]
        return [
            SourceSlice(
                source=self.source,
                source_kind=self.source_kind,
                transport=self.transport,
                start_unit=0,
                stop_unit=num_units,
                seeding=self.seeding,
                source_shards=self.source_shards,
                codec=self.codec,
            )
        ]
