"""The resharding planner: mismatched layouts -> striped interval reads.

For every destination shard, the planner intersects its slice of each
tensor against every source shard's slice and emits an ordered list of
:class:`ReadInterval` — byte-range reads striped across *all* source
shards — that exactly tiles every destination tensor. See the package
docstring for the layout-descriptor format.

Algorithm (per destination shard, per tensor)
---------------------------------------------

1. Decompose each non-empty intersection ``dest_slice ∩ src_slice_j``
   into contiguous *runs*: byte ranges contiguous in BOTH the source
   shard's local buffer and the destination shard's local buffer
   (C-order rows along the last dim, merged when adjacent). Dim-0
   sharding — the common TP case — merges to a single run.
2. Sweep the destination's local byte space over run boundaries; every
   elementary segment is assigned to the least-loaded source shard that
   covers it (load = bytes already assigned to that source shard by this
   destination shard). Segments covered by several source shards
   (replicated tensors, overlapping slices) are additionally split into
   stripes so no single source serializes the read.
3. A segment no source covers means the layouts are not convertible:
   :class:`repro.core.errors.ShardLayoutError`.

Every interval is annotated with the source transfer unit that carries
its bytes (pipeline gating: the read may start once the source's progress
counter passes that unit) and the destination unit it lands in (progress
is published in completed destination units).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.errors import ShardLayoutError
from repro_torch.resharding import rowgrid
from repro_torch.resharding.layout import ReplicaLayout, ShardSlice, TensorLayout

#: segments covered by >1 source shard are split into stripes of at least
#: this many bytes (smaller segments are not worth fragmenting)
STRIPE_MIN_BYTES = 1 << 20


@dataclasses.dataclass(frozen=True)
class ReadInterval:
    """One striped read: a byte range of a source shard's local tensor
    buffer landing at a byte range of the destination's local buffer.

    Reads execute in *unit space*: ``src_unit_offset`` places the range
    inside the source TransferUnit's payload (tensor offset plus the
    member offset for compacted buckets), and ``lead``/``tail`` widen it
    to the quantization row grid of the plan's codec so the source can
    encode the range (``raw`` plans have zero widening). The transport
    reads ``[read_offset, read_offset + read_nbytes)`` of the unit; the
    destination trims ``lead``/``tail`` from the decoded bytes — or the
    fused dequant+gather kernel simply never gathers them.
    """

    tensor: str
    source_shard: int
    src_offset: int  # bytes, within the source shard's local tensor buffer
    dst_offset: int  # bytes, within the dest shard's local tensor buffer
    nbytes: int
    source_unit: int  # TransferUnit index carrying the bytes at the source
    dest_unit: int  # TransferUnit index the bytes land in at the dest
    #: byte offset of this range inside the source unit's payload
    #: (-1: unknown — legacy plans; treat as ``src_offset``)
    src_unit_offset: int = -1
    #: total payload bytes of the source unit (0 when unknown)
    src_unit_nbytes: int = 0
    #: row-grid widening in bytes before/after the range (0 for raw)
    lead: int = 0
    tail: int = 0

    @property
    def src_stop(self) -> int:
        return self.src_offset + self.nbytes

    @property
    def dst_stop(self) -> int:
        return self.dst_offset + self.nbytes

    @property
    def read_offset(self) -> int:
        """Unit-payload byte offset the transport actually reads from."""
        base = self.src_unit_offset if self.src_unit_offset >= 0 else self.src_offset
        return base - self.lead

    @property
    def read_nbytes(self) -> int:
        """Bytes the transport actually reads (row-grid widened)."""
        return self.lead + self.nbytes + self.tail


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """All interval reads for one destination shard, ordered by
    destination unit (then tensor, then destination offset) so that a
    prefix of completed units maps to a monotone progress counter."""

    dest_shard: int
    intervals: Tuple[ReadInterval, ...]
    num_dest_units: int
    total_bytes: int

    @property
    def bytes_per_source(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for iv in self.intervals:
            out[iv.source_shard] = out.get(iv.source_shard, 0) + iv.nbytes
        return out

    @property
    def source_shards_used(self) -> Tuple[int, ...]:
        return tuple(sorted({iv.source_shard for iv in self.intervals}))

    def intervals_by_unit(self) -> Dict[int, List[ReadInterval]]:
        """Intervals bucketed by destination unit in plan order — one
        pass; callers iterating per unit use this instead of repeated
        linear scans."""
        out: Dict[int, List[ReadInterval]] = {}
        for iv in self.intervals:
            out.setdefault(iv.dest_unit, []).append(iv)
        return out

    def intervals_for_unit(self, dest_unit: int) -> List[ReadInterval]:
        return [iv for iv in self.intervals if iv.dest_unit == dest_unit]


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """Per-destination-shard plans plus the layouts they were built from."""

    source: ReplicaLayout
    dest: ReplicaLayout
    shards: Tuple[ShardPlan, ...]

    def shard(self, dest_shard: int) -> ShardPlan:
        for p in self.shards:
            if p.dest_shard == dest_shard:
                return p
        raise KeyError(dest_shard)

    @property
    def total_bytes(self) -> int:
        return sum(p.total_bytes for p in self.shards)


# ---------------------------------------------------------------------------
# run decomposition
# ---------------------------------------------------------------------------


def _ravel(coord: Sequence[int], shape: Sequence[int]) -> int:
    off = 0
    for c, n in zip(coord, shape):
        off = off * n + c
    return off


def _intersection_runs(
    dest: ShardSlice, src: ShardSlice, itemsize: int
) -> List[Tuple[int, int, int]]:
    """Contiguous runs of ``dest ∩ src`` as ``(dst_off, src_off, nbytes)``
    byte triples, offsets local to each side's buffer. Empty when the
    slices don't overlap."""
    ndim = max(len(dest.shape), 1)
    d_start = dest.start or (0,)
    d_shape = dest.shape or (1,)
    s_start = src.start or (0,)
    s_shape = src.shape or (1,)
    lo = tuple(max(a, b) for a, b in zip(d_start, s_start))
    hi = tuple(
        min(a + n, b + m)
        for a, n, b, m in zip(d_start, d_shape, s_start, s_shape)
    )
    if any(h <= l for l, h in zip(lo, hi)):
        return []
    ext = tuple(h - l for l, h in zip(lo, hi))
    row_elems = ext[-1]
    runs: List[Tuple[int, int, int]] = []
    for lead in itertools.product(*(range(l, h) for l, h in zip(lo[:-1], hi[:-1]))):
        coord = (*lead, lo[-1])
        dst_off = _ravel(
            tuple(c - o for c, o in zip(coord, d_start)), d_shape
        ) * itemsize
        src_off = _ravel(
            tuple(c - o for c, o in zip(coord, s_start)), s_shape
        ) * itemsize
        nbytes = row_elems * itemsize
        if runs and runs[-1][0] + runs[-1][2] == dst_off and runs[-1][1] + runs[-1][2] == src_off:
            prev = runs[-1]
            runs[-1] = (prev[0], prev[1], prev[2] + nbytes)
        else:
            runs.append((dst_off, src_off, nbytes))
    del ndim
    return runs


# ---------------------------------------------------------------------------
# coverage sweep + load balancing
# ---------------------------------------------------------------------------


def _plan_tensor(
    tensor: TensorLayout,
    dest_slice: ShardSlice,
    load: Dict[int, int],
    *,
    stripe_min: int,
    codec: str = "raw",
) -> List[ReadInterval]:
    """Assign every byte of the destination slice to a source shard."""
    from repro_torch.transfer.codec import get_codec

    local_bytes = tensor.itemsize
    for d in dest_slice.shape or (1,):
        local_bytes *= d
    if local_bytes == 0:
        return []
    # (dst_off, src_off, nbytes) runs per candidate source shard, plus
    # each candidate's unit placement and row-grid granularity
    runs: Dict[int, List[Tuple[int, int, int]]] = {}
    place: Dict[int, ShardSlice] = {}
    rb_of: Dict[int, int] = {}
    wire = get_codec(codec)
    for src_slice in tensor.slices:
        r = _intersection_runs(dest_slice, src_slice, tensor.itemsize)
        if r:
            runs[src_slice.shard] = r
            place[src_slice.shard] = src_slice
            rb_of[src_slice.shard] = wire.row_bytes(src_slice.unit_dtype)
    # sweep over the dest slice's local byte space
    cuts = {0, local_bytes}
    for rs in runs.values():
        for dst_off, _, nbytes in rs:
            cuts.add(dst_off)
            cuts.add(dst_off + nbytes)
    edges = sorted(c for c in cuts if 0 <= c <= local_bytes)
    intervals: List[ReadInterval] = []

    def emit(shard: int, dst_a: int, dst_b: int, src_off: int) -> None:
        p = place[shard]
        unit_off = p.unit_offset + src_off
        lead, tail = rowgrid.snap(
            unit_off, dst_b - dst_a, rb_of[shard], p.unit_nbytes
        )
        intervals.append(
            ReadInterval(
                tensor=tensor.name,
                source_shard=shard,
                src_offset=src_off,
                dst_offset=dst_a,
                nbytes=dst_b - dst_a,
                source_unit=p.unit,
                dest_unit=dest_slice.unit,
                src_unit_offset=unit_off,
                src_unit_nbytes=p.unit_nbytes,
                lead=lead,
                tail=tail,
            )
        )
        load[shard] = load.get(shard, 0) + (dst_b - dst_a)

    for a, b in zip(edges[:-1], edges[1:]):
        # candidates covering [a, b): (shard, src byte offset at a)
        cands: List[Tuple[int, int]] = []
        for shard, rs in runs.items():
            for dst_off, src_off, nbytes in rs:
                if dst_off <= a and b <= dst_off + nbytes:
                    cands.append((shard, src_off + (a - dst_off)))
                    break
        if not cands:
            raise ShardLayoutError(
                f"tensor {tensor.name!r}: destination bytes [{a}, {b}) of "
                f"shard {dest_slice.shard} are not covered by any source "
                "shard (layouts not convertible)"
            )
        if len(cands) == 1 or b - a < 2 * stripe_min:
            shard, src_off = min(
                cands, key=lambda c: (load.get(c[0], 0), c[0])
            )
            emit(shard, a, b, src_off)
            continue
        # replicated / overlapping region: stripe across the candidates.
        # Stripe size is rounded up to the coarsest candidate row grid so
        # interior boundaries stay row-aligned (zero widening) whenever
        # the region itself starts on a row boundary.
        n_stripes = min(len(cands), max(2, (b - a) // stripe_min))
        per = rowgrid.chunk_align(
            (b - a) // n_stripes, max(rb_of[s] for s, _ in cands)
        )
        pos = a
        order = sorted(cands, key=lambda c: (load.get(c[0], 0), c[0]))
        k = 0
        while pos < b:
            stop = b if k >= n_stripes - 1 else min(pos + per, b)
            shard, src_base = order[k % len(order)]
            emit(shard, pos, stop, src_base + (pos - a))
            pos = stop
            k += 1
    return intervals


def plan_shard(
    source: ReplicaLayout,
    dest: ReplicaLayout,
    dest_shard: int,
    *,
    stripe_min: int = STRIPE_MIN_BYTES,
    num_dest_units: Optional[int] = None,
    codec: str = "raw",
) -> ShardPlan:
    """Plan all interval reads for one destination shard.

    ``codec`` is the negotiated wire codec the reads will carry: interval
    boundaries are snapped to its quantization row grid (``lead``/``tail``
    widening) so every read is encodable at the source. ``raw`` plans
    have zero widening and are bit-identical to pre-codec plans.
    """
    _check_convertible(source, dest)
    load: Dict[int, int] = {}
    intervals: List[ReadInterval] = []
    max_unit = -1
    for tensor in dest.tensors:
        d_slice = tensor.slice_for(dest_shard)
        if d_slice is None:
            continue  # this shard holds no block of the tensor
        max_unit = max(max_unit, d_slice.unit)
        src_tensor = source.tensor(tensor.name)
        assert src_tensor is not None  # _check_convertible guarantees it
        intervals.extend(
            _plan_tensor(
                src_tensor, d_slice, load, stripe_min=stripe_min, codec=codec
            )
        )
    intervals.sort(key=lambda iv: (iv.dest_unit, iv.tensor, iv.dst_offset))
    plan = ShardPlan(
        dest_shard=dest_shard,
        intervals=tuple(intervals),
        num_dest_units=(max_unit + 1 if num_dest_units is None else num_dest_units),
        total_bytes=sum(iv.nbytes for iv in intervals),
    )
    validate_shard_plan(plan, dest, dest_shard)
    return plan


def plan_reshard(
    source: ReplicaLayout,
    dest: ReplicaLayout,
    *,
    stripe_min: int = STRIPE_MIN_BYTES,
    codec: str = "raw",
) -> ReshardPlan:
    """Plan every destination shard's reads from the source layout."""
    shards = sorted({s.shard for t in dest.tensors for s in t.slices})
    return ReshardPlan(
        source=source,
        dest=dest,
        shards=tuple(
            plan_shard(source, dest, d, stripe_min=stripe_min, codec=codec)
            for d in shards
        ),
    )


def _check_convertible(source: ReplicaLayout, dest: ReplicaLayout) -> None:
    src_names = set(source.names())
    dst_names = set(dest.names())
    if src_names != dst_names:
        missing = sorted(dst_names - src_names)
        extra = sorted(src_names - dst_names)
        raise ShardLayoutError(
            f"layouts not convertible: tensors missing at source {missing}, "
            f"extra at source {extra}"
        )
    for d_tensor in dest.tensors:
        s_tensor = source.tensor(d_tensor.name)
        assert s_tensor is not None
        if s_tensor.global_shape != d_tensor.global_shape:
            raise ShardLayoutError(
                f"tensor {d_tensor.name!r}: global shape mismatch "
                f"({s_tensor.global_shape} vs {d_tensor.global_shape})"
            )
        if s_tensor.dtype != d_tensor.dtype:
            raise ShardLayoutError(
                f"tensor {d_tensor.name!r}: dtype mismatch "
                f"({s_tensor.dtype} vs {d_tensor.dtype})"
            )


def validate_shard_plan(
    plan: ShardPlan, dest: ReplicaLayout, dest_shard: int
) -> None:
    """Exact-tiling invariant: the plan's destination byte ranges tile
    every destination tensor with no gaps and no overlaps, and every
    row-grid-widened read stays inside its source unit's payload."""
    by_tensor: Dict[str, List[ReadInterval]] = {}
    for iv in plan.intervals:
        by_tensor.setdefault(iv.tensor, []).append(iv)
        if iv.read_offset < 0 or (
            0 < iv.src_unit_nbytes < iv.read_offset + iv.read_nbytes
        ):
            raise ShardLayoutError(
                f"plan invalid: widened read [{iv.read_offset}, "
                f"{iv.read_offset + iv.read_nbytes}) of tensor "
                f"{iv.tensor!r} escapes source unit {iv.source_unit} "
                f"({iv.src_unit_nbytes}B) on source shard {iv.source_shard}"
            )
    for tensor in dest.tensors:
        d_slice = tensor.slice_for(dest_shard)
        if d_slice is None:
            continue
        local_bytes = tensor.itemsize
        for d in d_slice.shape or (1,):
            local_bytes *= d
        ivs = sorted(by_tensor.get(tensor.name, []), key=lambda i: i.dst_offset)
        pos = 0
        for iv in ivs:
            if iv.dst_offset != pos:
                kind = "overlap" if iv.dst_offset < pos else "gap"
                raise ShardLayoutError(
                    f"plan invalid: {kind} at byte {min(pos, iv.dst_offset)} "
                    f"of tensor {tensor.name!r} on dest shard {dest_shard}"
                )
            pos = iv.dst_stop
        if pos != local_bytes:
            raise ShardLayoutError(
                f"plan invalid: tensor {tensor.name!r} on dest shard "
                f"{dest_shard} covered to byte {pos} of {local_bytes}"
            )
