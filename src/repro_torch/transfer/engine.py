"""Transfer engine: worker-side data plane (4.3.2).

``WorkerStore`` is the per-worker registry of weight buffers — the memory
that the reference server hands out references *to*. The store builds the
transfer-unit schedule (tiny-tensor compaction, 4.3.2) and serves/absorbs
unit payloads.

``Transport`` abstracts the wire. The paper's engine has three modes (RDMA
direct / RDMA copy / TCP) built on Mooncake; here :class:`LocalTransport`
makes real in-process copies between stores. A store holds its tensors
in place on its device (the card, or the CPU for the host-RAM offload and
seed stores): every copy, gather, codec pass and checksum of a unit runs
where its bytes live, and the "wire copy" of a pull lands on the
destination's device.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.errors import (  # noqa: F401  (TransportError re-exported:
    # it lived here before joining the error taxonomy in core.errors)
    ChecksumError,
    NotRegisteredError,
    TensorHubError,
    TransportError,
)
from repro_torch.core.meta import (  # noqa: F401  (DEFAULT_* re-exported)
    DEFAULT_CHUNK_BYTES,
    DEFAULT_WINDOW,
    ShardManifest,
    TensorMeta,
    TransferUnit,
    build_units,
    dtype_name,
)
from repro_torch.obs import telemetry as obs
from repro_torch.transfer import checksum as checksum_lib
from repro_torch.transfer import codec as codec_lib

#: per-tensor layout descriptor: (global_shape, offset) — see
#: ``repro_torch.resharding`` for the format
LayoutEntry = Tuple[Tuple[int, ...], Tuple[int, ...]]


def resolve_device(device) -> torch.device:
    """A concrete device for a store or client: ``"cuda"`` becomes the
    current card (so it compares equal to its tensors' ``cuda:N``).
    Raises, and never falls back to the CPU, when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise TensorHubError(
                f"device {device!r} requested but CUDA is not available; pass "
                "device='cpu' explicitly to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise TensorHubError(f"unsupported device {device!r}")
    return dev


def tensor_meta(
    name: str, arr: torch.Tensor, layout: Optional[LayoutEntry] = None
) -> TensorMeta:
    gshape, offset = layout if layout is not None else (None, None)
    return TensorMeta(
        name=name,
        shape=tuple(arr.shape),
        dtype=dtype_name(arr.dtype),
        nbytes=arr.nbytes,
        global_shape=gshape,
        offset=offset,
    )


class WorkerStore:
    """Registered weight buffers of one shard-owning worker.

    Buffers are torch tensors held in place on the store's ``device`` —
    the card's HBM for a GPU worker, host RAM for the offload and seed
    stores; the store never makes a host copy. The store is thread-safe:
    publishes are immutable by contract, so readers take no lock on the
    bytes themselves — only registry mutations lock, mirroring one-sided
    RDMA semantics.
    """

    def __init__(self, worker_id: str, device="cuda", keep_base: bool = True) -> None:
        self.worker_id = worker_id
        #: whether ``snapshot_base`` keeps a delta base (a second copy of
        #: the weights on ``device``); without one a delta read from or
        #: into this store ships a base-codec frame, as after ``drop_base``
        self.keep_base = keep_base
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._buffers: Dict[str, torch.Tensor] = {}
        self._layouts: Dict[str, LayoutEntry] = {}
        self._units: List[TransferUnit] = []
        self._metas: List[TensorMeta] = []
        self._meta_by_name: Dict[str, TensorMeta] = {}
        self._unit_of: Dict[str, int] = {}
        #: simulate preemption: a failed store refuses all reads
        self.failed = False
        #: delta-transfer base snapshot: the most recent published
        #: version's unit payloads, captured at unpublish/update time so
        #: this worker can serve (or receive) int8 residuals against it.
        #: Deliberately NOT cleared by ``register`` — the publisher
        #: re-registers v(n+1) buffers between unpublish and publish, and
        #: the snapshot of v(n) must survive that to serve residuals.
        self._base_version: Optional[int] = None
        self._base_units: Dict[str, torch.Tensor] = {}
        #: swarm replication served-prefix watermark: while this shard is
        #: itself mid-replication, only units ``[0, serving_prefix)`` hold
        #: final bytes and may be served to swarm readers. ``None`` means
        #: unrestricted (publishers, completed replicas). The owner's pull
        #: loop advances it *before* reporting progress to the server, so
        #: any unit the scheduler shows as available is readable here — a
        #: read past the watermark is a planner/claim bug, not a race.
        self.serving_prefix: Optional[int] = None

    # -- registration ----------------------------------------------------------

    def register(
        self,
        named_tensors: Mapping[str, torch.Tensor],
        *,
        layout: Optional[Mapping[str, LayoutEntry]] = None,
    ) -> None:
        """Register weight buffers in place; ``layout`` optionally stamps
        each tensor's layout descriptor (global shape + slice offset) onto
        its metadata so cross-layout readers can reshard from this shard.

        Tensors must already live on the store's device (a pull writes
        into them there); a non-contiguous tensor is replaced by a
        contiguous copy, as the JAX package's store does.

        Registration asserts ownership of the buffers, so any served-prefix
        watermark left behind by an earlier aborted pull is lifted — a
        stale watermark would otherwise poison every later version served
        from this store."""
        for name, arr in named_tensors.items():
            if not isinstance(arr, torch.Tensor) or arr.device != self.device:
                where = arr.device if isinstance(arr, torch.Tensor) else type(arr).__name__
                raise TensorHubError(
                    f"{self.worker_id}: tensor {name} is on {where}, the store "
                    f"holds its buffers on {self.device}"
                )
        self.serving_prefix = None
        with self._lock:
            for name, arr in named_tensors.items():
                self._buffers[name] = arr if arr.is_contiguous() else arr.contiguous()
                if layout is not None and name in layout:
                    self._layouts[name] = layout[name]
            self._rebuild_units()

    def unregister(self, names: Optional[Sequence[str]] = None) -> None:
        with self._lock:
            if names is None:
                self._buffers.clear()
                self._layouts.clear()
            else:
                for n in names:
                    self._buffers.pop(n, None)
                    self._layouts.pop(n, None)
            self._rebuild_units()

    def _rebuild_units(self) -> None:
        self._metas = [
            tensor_meta(n, a, self._layouts.get(n)) for n, a in self._buffers.items()
        ]
        self._meta_by_name = {m.name: m for m in self._metas}
        self._units = build_units(self._metas)
        self._unit_of = {}
        for u in self._units:
            self._unit_of[u.name] = u.index
            for m in u.members:
                self._unit_of[m] = u.index

    def unit_dtype(self, unit: TransferUnit) -> Optional[str]:
        """Element dtype of a unit's payload (None for mixed-dtype compact
        buckets) — what a wire codec needs to quantize the bytes."""
        return codec_lib.unit_wire_dtype(self._meta_by_name, unit)

    def _check_served(self, unit_index: int, what: str) -> None:
        """Never-read-past-source-prefix guard (swarm replication)."""
        sp = self.serving_prefix
        if sp is not None and unit_index >= sp:
            raise TensorHubError(
                f"{self.worker_id}: read of {what} (unit {unit_index}) beyond "
                f"the served prefix [0, {sp}) — the bytes there are not final; "
                "swarm readers must gate on the source's progress counter"
            )

    @property
    def layouts(self) -> Dict[str, LayoutEntry]:
        return dict(self._layouts)

    @property
    def units(self) -> List[TransferUnit]:
        return list(self._units)

    @property
    def metas(self) -> List[TensorMeta]:
        return list(self._metas)

    @property
    def total_bytes(self) -> int:
        return sum(u.nbytes for u in self._units)

    def tensors(self) -> Dict[str, torch.Tensor]:
        with self._lock:
            return dict(self._buffers)

    def get(self, name: str) -> torch.Tensor:
        return self._buffers[name]

    # -- manifest / checksums ----------------------------------------------------

    def build_manifest(self, *, with_checksums: bool = True) -> ShardManifest:
        if not self._buffers:
            raise NotRegisteredError(f"{self.worker_id}: no tensors registered")
        sums = tuple(
            checksum_lib.checksum(self._gather_unit(u)) if with_checksums else 0
            for u in self._units
        )
        return ShardManifest(
            tensors=tuple(self._metas), units=tuple(self._units), checksums=sums
        )

    # -- unit payload serve/absorb ------------------------------------------------

    def read_unit(self, unit: TransferUnit) -> torch.Tensor:
        """Serve one transfer unit as a flat byte tensor on this store's
        device (zero-copy for large tensors; gather-into-staging for
        compacted buckets — the paper's RDMA-copy path). Transport-facing:
        refuses reads of units beyond the served prefix while this shard
        is itself mid-replication."""
        if self.failed:
            raise TransportError(f"{self.worker_id} is dead")
        self._check_served(unit.index, unit.name)
        return self._gather_unit(unit)

    def _gather_unit(self, unit: TransferUnit) -> torch.Tensor:
        """Owner-local unit gather (manifest checksums, snapshots): not
        prefix-guarded — the owner may always see its own buffers."""
        if not unit.is_compact:
            arr = self._buffers.get(unit.name)
            if arr is None:
                raise NotRegisteredError(f"{self.worker_id}: unknown tensor {unit.name}")
            return codec_lib.as_bytes(arr)
        staging = torch.empty(unit.nbytes, dtype=torch.uint8, device=self.device)
        for name, off, nbytes in unit.layout:
            staging[off : off + nbytes] = codec_lib.as_bytes(self._buffers[name])
        return staging

    def write_unit(self, unit: TransferUnit, payload: torch.Tensor) -> None:
        """Absorb one transfer unit into the registered buffers in place
        (copied onto this store's device if the payload lies elsewhere).

        Like the read paths, a failed (preempted) store refuses the
        write: a dead worker silently accepting bytes would let a pull
        "complete" into memory nobody will ever serve or use."""
        if self.failed:
            raise TransportError(f"{self.worker_id} is dead")
        if payload.nbytes != unit.nbytes:
            raise TensorHubError(
                f"unit {unit.name}: payload {payload.nbytes}B != expected {unit.nbytes}B"
            )
        flat = codec_lib.as_bytes(payload)
        if not unit.is_compact:
            dst = self._buffers.get(unit.name)
            if dst is None:
                raise NotRegisteredError(f"{self.worker_id}: unknown tensor {unit.name}")
            codec_lib.as_bytes(dst).copy_(flat)
            return
        for name, off, nbytes in unit.layout:
            codec_lib.as_bytes(self._buffers[name]).copy_(flat[off : off + nbytes])

    # -- sub-unit byte ranges (cross-layout resharding) ---------------------------

    def read_range(self, name: str, offset: int, nbytes: int) -> torch.Tensor:
        """Serve a byte range of one tensor's local buffer (zero-copy
        view; the transport makes the wire copy). The striped reads of a
        reshard plan are exactly these one-sided range reads."""
        if self.failed:
            raise TransportError(f"{self.worker_id} is dead")
        idx = self._unit_of.get(name)
        if idx is not None:
            self._check_served(idx, name)
        arr = self._buffers.get(name)
        if arr is None:
            raise NotRegisteredError(f"{self.worker_id}: unknown tensor {name}")
        if offset < 0 or offset + nbytes > arr.nbytes:
            raise TensorHubError(
                f"{self.worker_id}/{name}: range [{offset}, {offset + nbytes}) "
                f"exceeds buffer of {arr.nbytes}B"
            )
        return codec_lib.as_bytes(arr)[offset : offset + nbytes]

    def write_range(self, name: str, offset: int, payload: torch.Tensor) -> None:
        """Absorb a byte range (reshard staging writes). Refuses writes on
        a failed store, mirroring ``read_range`` — a dead worker must not
        silently accept bytes."""
        if self.failed:
            raise TransportError(f"{self.worker_id} is dead")
        dst = self._buffers.get(name)
        if dst is None:
            raise NotRegisteredError(f"{self.worker_id}: unknown tensor {name}")
        flat = codec_lib.as_bytes(payload)
        if offset < 0 or offset + flat.nbytes > dst.nbytes:
            raise TensorHubError(
                f"{self.worker_id}/{name}: write [{offset}, {offset + flat.nbytes}) "
                f"exceeds buffer of {dst.nbytes}B"
            )
        codec_lib.as_bytes(dst)[offset : offset + flat.nbytes].copy_(flat)

    # -- delta-transfer base snapshots --------------------------------------------

    def snapshot_base(self, version: int) -> None:
        """Snapshot the currently registered unit payloads as the delta
        base for ``version`` (a copy on this store's device). Called by
        the client when a published version is retired (publisher
        unpublish) or superseded locally (destination about to pull an
        update) — both sides of a ``delta:<base>`` transfer encode/decode
        against these bytes. Only the most recent snapshot is kept (one
        version of history, matching the server's prior-version
        bookkeeping). A store that keeps no base drops any it holds."""
        if not self.keep_base:
            self.drop_base()
            return
        with self._lock:
            self._base_version = version
            self._base_units = {
                u.name: self._gather_unit(u).clone() for u in self._units
            }

    @property
    def base_version(self) -> Optional[int]:
        return self._base_version

    def base_unit(self, unit: TransferUnit) -> Optional[torch.Tensor]:
        """The snapshotted base payload for ``unit``, or ``None`` when no
        matching snapshot exists (name or size mismatch after a model
        change — the codec then falls back to a base-codec frame)."""
        arr = self._base_units.get(unit.name)
        if arr is None or arr.nbytes != unit.nbytes:
            return None
        return arr

    def drop_base(self) -> None:
        """Evict the delta base snapshot (GC / memory-pressure path; also
        what tests use to model a destination whose base is gone)."""
        with self._lock:
            self._base_version = None
            self._base_units = {}

    # -- offload ------------------------------------------------------------------

    def snapshot_to(self, other: "WorkerStore") -> None:
        """Copy all registered buffers into another store, on that store's
        device (the CPU offload path of the retention protocol, 3.3 —
        PCIe copy in the paper)."""
        with self._lock:
            other.register(
                {n: a.to(other.device, copy=True) for n, a in self._buffers.items()},
                layout=dict(self._layouts),
            )


class WorkerRegistry:
    """In-process lookup: (replica, shard_idx) -> WorkerStore.

    Stands in for the RDMA address exchange: the server hands out a replica
    name, the transport resolves it to memory it can read.
    """

    def __init__(self) -> None:
        self._stores: Dict[Tuple[str, int], WorkerStore] = {}
        self._lock = threading.Lock()

    def add(self, replica: str, shard_idx: int, store: WorkerStore) -> None:
        with self._lock:
            self._stores[(replica, shard_idx)] = store

    def remove(self, replica: str, shard_idx: int) -> None:
        with self._lock:
            self._stores.pop((replica, shard_idx), None)

    def get(self, replica: str, shard_idx: int) -> WorkerStore:
        with self._lock:
            store = self._stores.get((replica, shard_idx))
        if store is None or store.failed:
            raise TransportError(f"no live store for {replica}/shard{shard_idx}")
        return store

    def lookup(self, replica: str, shard_idx: int) -> Optional[WorkerStore]:
        """The registered store, live or failed, or ``None`` when this
        process holds no entry at all. The networked transport uses the
        distinction: a locally-registered-but-dead store must fail fast
        (as :meth:`get` does), while an *absent* one means the source
        lives in another process and the read goes over the wire."""
        with self._lock:
            return self._stores.get((replica, shard_idx))

    def fail_replica(self, replica: str) -> None:
        """Kill every shard of a replica (spot preemption in tests)."""
        with self._lock:
            for (r, _), store in self._stores.items():
                if r == replica:
                    store.failed = True


class LocalTransport:
    """Real byte-copy transport between in-process stores."""

    def __init__(
        self,
        registry: WorkerRegistry,
        *,
        verify_checksums: bool = True,
        recorder: Optional[obs.Recorder] = None,
        faults=None,
    ) -> None:
        self.registry = registry
        self.verify_checksums = verify_checksums
        self.recorder = obs.DISABLED if recorder is None else recorder
        #: optional gray-fault injector (``repro_torch.transfer.faults``):
        #: consulted at the top of every read (hang/slow/flaky) and on
        #: served payloads ahead of verification (corrupt byte-flips)
        self.faults = faults
        self.bytes_moved = 0
        # Per-link-class byte accounting, mirroring the simulator's link
        # (repro_torch.transfer.simcluster's) tags ("rdma" intra-DC, "vpc_up" WAN, "pcie" offload): wire
        # bytes are what the NIC carried (post-codec), decoded bytes the
        # payload delivered. Always on — the cross-DC benchmarks assert
        # sim-vs-threaded parity from these counters.
        self.wire_bytes: Dict[str, int] = {}
        self.decoded_bytes: Dict[str, int] = {}
        #: delta transfers that hit a stale/evicted destination base and
        #: transparently re-fetched through the base codec (the wire
        #: carried both frames; final bytes are byte-identical to a plain
        #: base-codec pull)
        self.delta_stale_fallbacks = 0
        self._acct_lock = threading.Lock()

    def _fault_read(self, src_replica: str, shard_idx: int) -> None:
        if self.faults is not None:
            self.faults.before_read(src_replica, shard_idx)

    def _fault_flip(self, src_replica: str, payload: torch.Tensor, verified: bool) -> None:
        # only flip bytes a checksum will catch: an unverified flip would
        # silently propagate instead of exercising the reject path
        if verified and self.faults is not None and self.faults.corrupts(src_replica):
            self.faults.flip(payload)

    def _fault_truncate(self, src_replica: str, wire: torch.Tensor) -> torch.Tensor:
        """Torn-frame injection on codec wires: drop the frame's tail so
        the destination's decode fails the wire-level size integrity
        check (a CodecError, not a ChecksumError — the decode-failure
        healing path)."""
        if self.faults is not None and self.faults.truncates(src_replica):
            return wire[: wire.nbytes - max(1, wire.nbytes // 4)]
        return wire

    @staticmethod
    def _dest_base(dst_store: WorkerStore, unit: TransferUnit) -> Optional[torch.Tensor]:
        """The destination's currently-held bytes for ``unit`` — the base
        a delta frame's residuals are summed against. ``None`` when the
        destination has no matching buffers (fresh replica, model
        change); the codec's digest check catches every subtler mismatch."""
        try:
            return dst_store._gather_unit(unit)
        except (TensorHubError, KeyError):
            return None

    def _account(self, link_class: str, wire_nbytes: int, decoded_nbytes: int) -> None:
        # windowed pulls share one transport across span-worker threads
        with self._acct_lock:
            self.bytes_moved += wire_nbytes
            self.wire_bytes[link_class] = self.wire_bytes.get(link_class, 0) + wire_nbytes
            self.decoded_bytes[link_class] = (
                self.decoded_bytes.get(link_class, 0) + decoded_nbytes
            )

    def pull_unit(
        self,
        src_replica: str,
        shard_idx: int,
        unit: TransferUnit,
        expected_checksum: int,
        dst_store: WorkerStore,
        codec: str = "raw",
        link_class: str = "rdma",
        track: Optional[str] = None,
    ) -> None:
        """Pull one whole transfer unit through the negotiated wire codec.

        ``codec="raw"`` is the pre-codec wire bit-for-bit: payload bytes
        move unframed and are verified against the *publish-time* manifest
        checksum. A non-raw codec encodes at the source and decodes at the
        destination; end-to-end verification then runs over the **decoded**
        bytes — the source checksums ``decode(encode(payload))`` at read
        time (a lossy codec's output cannot match the publish-time sum)
        and the reader re-verifies after the wire copy, the same transit
        contract as :meth:`read_unit_range`. ``bytes_moved`` counts wire
        bytes, i.e. what the NIC actually carried."""
        src = self.registry.get(src_replica, shard_idx)
        self._fault_read(src_replica, shard_idx)
        cdc = codec_lib.get_codec(codec)
        rec = self.recorder
        if codec == "raw":
            # the wire copy, onto the destination's device
            payload = src.read_unit(unit).to(dst_store.device, copy=True)
            self._fault_flip(
                src_replica,
                payload,
                self.verify_checksums and bool(expected_checksum),
            )
            if self.verify_checksums and expected_checksum:
                t0 = rec.clock() if rec.enabled else 0.0
                got = checksum_lib.checksum(payload)
                if rec.enabled:
                    rec.counter_add(obs.CTR_VERIFY, rec.clock() - t0)
                    if track is not None:
                        rec.event("verify", track=track, unit=unit.name)
                if got != expected_checksum:
                    raise ChecksumError(
                        f"unit {unit.name} from {src_replica}/shard{shard_idx}: "
                        f"checksum {got:#x} != expected {expected_checksum:#x}"
                    )
            dst_store.write_unit(unit, payload)
            self._account(link_class, unit.nbytes, unit.nbytes)
            return
        t0 = rec.clock() if rec.enabled else 0.0
        raw_payload = src.read_unit(unit)
        dtype = src.unit_dtype(unit)
        if getattr(cdc, "needs_base", False):
            # delta codec: encode residuals against the SOURCE's snapshot
            # of the base version, decode them against the DESTINATION's
            # held bytes. A stale/evicted destination base raises
            # StaleBaseError, handled HERE — the source is not at fault,
            # so it must never surface as corruption evidence; the unit
            # transparently re-ships as a base-codec frame (both frames
            # crossed the wire, and accounting says so).
            wire = cdc.encode(raw_payload, dtype, base=src.base_unit(unit))
            wire = self._fault_truncate(src_replica, wire)
            wire_nbytes = wire.nbytes
            try:
                decoded_src = cdc.decode(wire, base=self._dest_base(dst_store, unit))
            except codec_lib.StaleBaseError:
                with self._acct_lock:
                    self.delta_stale_fallbacks += 1
                if rec.enabled:
                    rec.counter_add(obs.CTR_DELTA_STALE, 1)
                    if track is not None:
                        rec.event(
                            "delta_stale_fallback",
                            track=track,
                            unit=unit.name,
                            codec=codec,
                        )
                wire = self._fault_truncate(
                    src_replica, cdc.encode(raw_payload, dtype)
                )
                wire_nbytes += wire.nbytes
                decoded_src = cdc.decode(wire)
        else:
            wire = cdc.encode(raw_payload, dtype)
            wire = self._fault_truncate(src_replica, wire)
            wire_nbytes = wire.nbytes
            # decode ONCE (deterministic, and it validates the wire
            # framing); the source's advertised checksum is folded over
            # these decoded bytes, and the copy below models the wire
            # transfer + the destination's decode — so the comparison
            # still runs over two distinct buffers, without paying a
            # second dequantize
            decoded_src = cdc.decode(wire)
        if rec.enabled:
            rec.counter_add(obs.CTR_DECODE, rec.clock() - t0)
            if track is not None:
                rec.event("decode", track=track, unit=unit.name, codec=codec,
                          wire_bytes=wire_nbytes)
        t0 = rec.clock() if rec.enabled else 0.0
        expected = (
            checksum_lib.checksum(decoded_src) if self.verify_checksums else 0
        )
        t_verify = (rec.clock() - t0) if rec.enabled else 0.0
        # the wire copy, decoded at the dest
        payload = decoded_src.to(dst_store.device, copy=True)
        self._fault_flip(src_replica, payload, self.verify_checksums)
        if self.verify_checksums:
            t0 = rec.clock() if rec.enabled else 0.0
            got = checksum_lib.checksum(payload)
            if rec.enabled:
                rec.counter_add(obs.CTR_VERIFY, t_verify + (rec.clock() - t0))
                if track is not None:
                    rec.event("verify", track=track, unit=unit.name)
            if got != expected:
                raise ChecksumError(
                    f"unit {unit.name} ({codec}) from "
                    f"{src_replica}/shard{shard_idx}: decoded checksum "
                    f"{got:#x} != expected {expected:#x}"
                )
        dst_store.write_unit(unit, payload)
        self._account(link_class, wire_nbytes, unit.nbytes)

    def read_unit_range(
        self,
        src_replica: str,
        shard_idx: int,
        unit: TransferUnit,
        offset: int,
        nbytes: int,
        codec: str = "raw",
        link_class: str = "rdma",
        dest_base: Optional[torch.Tensor] = None,
        decode: bool = True,
        device: Optional[torch.device] = None,
    ) -> torch.Tensor:
        """Pull one byte sub-range of a transfer unit (sub-unit chunking,
        and — since the row-grid reshard planner — every resharded
        interval read, which arrives here as a widened unit range).

        There is no manifest checksum at chunk granularity: the source
        checksums the range at read time and the reader re-verifies after
        the wire copy; for a raw codec the caller additionally verifies
        the *assembled* unit against the manifest checksum, so end-to-end
        protection is preserved under chunking.

        ``decode=False`` returns the *wire frame* instead of decoded
        payload bytes (non-raw, non-delta codecs only): the transit
        checksum then runs over the wire bytes and the caller decodes —
        the fused dequant+gather kernel parses frames and writes repacked
        rows directly, skipping the staging decode entirely. Byte
        accounting is identical to the decoding path (wire bytes on the
        wire, ``nbytes`` of payload represented).

        Non-raw codecs encode the chunk independently; the range is in
        *decoded* (payload) space and ``offset`` must sit on a codec row
        boundary (:meth:`~repro_torch.transfer.codec.WireCodec.row_bytes`) so
        the chunk's quantization rows coincide with the whole-unit
        encoding and the reassembled unit is bit-identical to an
        unchunked transfer. The per-chunk checksum runs over the decoded
        bytes, exactly as in :meth:`pull_unit`.

        ``device`` is where the wire copy lands (the destination's device;
        the source's when omitted), and where it is re-verified.

        For a delta codec the caller passes ``dest_base`` — the
        destination's held bytes for this exact chunk range (the
        transport has no destination store on this path). Row alignment
        makes the chunk's base digest well-defined: the held chunk at a
        row boundary is exactly the base-codec round-trip of the source
        snapshot's chunk.

        The swarm served-prefix guard applies at chunk granularity too:
        ``read_unit`` below refuses units past the source's watermark, so
        a chunk of a not-yet-final unit can never be served (chunk-level
        checksums alone would not catch it — they are computed at read
        time and would happily cover garbage)."""
        src = self.registry.get(src_replica, shard_idx)
        self._fault_read(src_replica, shard_idx)
        full = src.read_unit(unit)
        dev = src.device if device is None else device
        # a zero-length tail chunk (offset == nbytes == end of unit) is a
        # valid no-op read; negative lengths and any byte past the unit
        # end are not
        if nbytes < 0 or offset < 0 or offset + nbytes > full.nbytes:
            raise TensorHubError(
                f"unit {unit.name}: chunk [{offset}, {offset + nbytes}) "
                f"exceeds unit of {full.nbytes}B"
            )
        view = full[offset : offset + nbytes]
        rec = self.recorder
        if codec == "raw":
            t0 = rec.clock() if rec.enabled else 0.0
            expected = checksum_lib.checksum(view) if self.verify_checksums else 0
            t_verify = (rec.clock() - t0) if rec.enabled else 0.0
            payload = view.to(dev, copy=True)  # the wire copy
            self._fault_flip(src_replica, payload, self.verify_checksums)
            if self.verify_checksums:
                t0 = rec.clock() if rec.enabled else 0.0
                got = checksum_lib.checksum(payload)
                if rec.enabled:
                    rec.counter_add(obs.CTR_VERIFY, t_verify + (rec.clock() - t0))
                if got != expected:
                    raise ChecksumError(
                        f"chunk {unit.name}[{offset}:{offset + nbytes}] from "
                        f"{src_replica}/shard{shard_idx}: checksum {got:#x} != "
                        f"expected {expected:#x}"
                    )
            self._account(link_class, nbytes, nbytes)
            return payload
        cdc = codec_lib.get_codec(codec)
        dtype = src.unit_dtype(unit)
        rb = cdc.row_bytes(dtype)
        if offset % rb or (nbytes % rb and offset + nbytes != full.nbytes):
            raise codec_lib.CodecError(
                f"chunk {unit.name}[{offset}:{offset + nbytes}] not aligned "
                f"to the {codec} codec's {rb}B row granularity — the "
                "reassembled unit would diverge from an unchunked transfer"
            )
        if not decode:
            if getattr(cdc, "needs_base", False):
                raise codec_lib.CodecError(
                    f"wire-frame reads cannot carry the base-referencing "
                    f"codec {codec!r} (no destination base at frame "
                    "granularity) — resolve the reshard codec first"
                )
            t0 = rec.clock() if rec.enabled else 0.0
            wire = self._fault_truncate(src_replica, cdc.encode(view, dtype))
            if rec.enabled:
                rec.counter_add(obs.CTR_DECODE, rec.clock() - t0)
            t0 = rec.clock() if rec.enabled else 0.0
            expected = (
                checksum_lib.checksum(wire) if self.verify_checksums else 0
            )
            t_verify = (rec.clock() - t0) if rec.enabled else 0.0
            payload = wire.to(dev, copy=True)  # the wire copy, decoded by the caller
            self._fault_flip(src_replica, payload, self.verify_checksums)
            if self.verify_checksums:
                t0 = rec.clock() if rec.enabled else 0.0
                got = checksum_lib.checksum(payload)
                if rec.enabled:
                    rec.counter_add(
                        obs.CTR_VERIFY, t_verify + (rec.clock() - t0)
                    )
                if got != expected:
                    raise ChecksumError(
                        f"chunk {unit.name}[{offset}:{offset + nbytes}] "
                        f"({codec} wire) from {src_replica}/shard{shard_idx}: "
                        f"wire checksum {got:#x} != expected {expected:#x}"
                    )
            self._account(link_class, payload.nbytes, nbytes)
            return payload
        t0 = rec.clock() if rec.enabled else 0.0
        if getattr(cdc, "needs_base", False):
            base_full = src.base_unit(unit)
            base_view = (
                None if base_full is None else base_full[offset : offset + nbytes]
            )
            wire = self._fault_truncate(
                src_replica, cdc.encode(view, dtype, base=base_view)
            )
            wire_nbytes = wire.nbytes
            try:
                decoded_src = cdc.decode(wire, base=dest_base)
            except codec_lib.StaleBaseError:
                with self._acct_lock:
                    self.delta_stale_fallbacks += 1
                if rec.enabled:
                    rec.counter_add(obs.CTR_DELTA_STALE, 1)
                wire = self._fault_truncate(src_replica, cdc.encode(view, dtype))
                wire_nbytes += wire.nbytes
                decoded_src = cdc.decode(wire)
        else:
            wire = self._fault_truncate(src_replica, cdc.encode(view, dtype))
            wire_nbytes = wire.nbytes
            # single decode (see pull_unit): checksum the decoded bytes at
            # the source, copy models the wire + destination decode
            decoded_src = cdc.decode(wire)
        if rec.enabled:
            rec.counter_add(obs.CTR_DECODE, rec.clock() - t0)
        t0 = rec.clock() if rec.enabled else 0.0
        expected = (
            checksum_lib.checksum(decoded_src) if self.verify_checksums else 0
        )
        t_verify = (rec.clock() - t0) if rec.enabled else 0.0
        payload = decoded_src.to(dev, copy=True)  # the wire copy, decoded at the dest
        self._fault_flip(src_replica, payload, self.verify_checksums)
        if self.verify_checksums:
            t0 = rec.clock() if rec.enabled else 0.0
            got = checksum_lib.checksum(payload)
            if rec.enabled:
                rec.counter_add(obs.CTR_VERIFY, t_verify + (rec.clock() - t0))
            if got != expected:
                raise ChecksumError(
                    f"chunk {unit.name}[{offset}:{offset + nbytes}] ({codec}) "
                    f"from {src_replica}/shard{shard_idx}: decoded checksum "
                    f"{got:#x} != expected {expected:#x}"
                )
        self._account(link_class, wire_nbytes, nbytes)
        return payload

