"""The ROS reference server (3, 4).

The server is the *control plane only*: it tracks which workers hold which
versions of the model weights and routes read requests to the least-loaded,
topology-closest source. It never stores or forwards weight bytes.

Design notes
------------
* **Deterministic, single-threaded semantics.** Every public method mutates
  state atomically and returns immediately (no blocking inside the server).
  Blocking client semantics (replicate waits for a version, unpublish drains)
  are built from the pending-ticket / event machinery here. Concurrency
  wrappers (threads in the real client, virtual time in the simulator) live
  outside. This is what makes FoundationDB-style deterministic interleaving
  tests possible (4.6).
* **Transactions per model-parallel group** (4.4): each replica's shards
  issue an identical op sequence (SPMD); ops carry ``op_id``. The first
  shard's arrival executes the op on behalf of the group and caches the
  result; later shards consume the cached result, so the whole group
  observes one consistent snapshot regardless of interleaving.
* **Soft state** (4.5): everything here can be lost; a backup server is
  repopulated by the next round of publishes.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core import meta as meta_defaults
from repro_torch.core import versions as version_lib
from repro_torch.core.errors import (
    ConsistencyError,
    MutabilityViolationError,
    ServerUnavailableError,
    ShardLayoutError,
    StaleHandleError,
    TensorHubError,
    VersionUnavailableError,
)
from repro_torch.core.meta import Assignment, ShardManifest, SourceSlice, WorkerInfo
from repro_torch.core.oplog import OP_SCHEMAS, OpLog

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# The remotable control-plane surface
# ---------------------------------------------------------------------------
#
# ``ReferenceServer`` is transport-agnostic: every public method is a plain
# call that mutates atomically and returns immediately, so any transport —
# the in-process client, or the networked ``repro_torch.net`` service — is a thin
# dispatcher over this table. Mutating ops carry their wire schema in
# ``oplog.OP_SCHEMAS`` (the WAL payload IS the RPC payload); read-only ops
# declare theirs here. Anything not in ``CONTROL_OPS`` is not remotable:
# the networked service refuses it, so a forged frame can never reach
# private state (``_record``, ``__class__``, ...).

#: read-only ops: name -> positional argument names (keyword-only arguments
#: ride the request's ``kw`` map and are listed after a ``*`` marker).
READONLY_OPS: Dict[str, tuple] = {
    "get_assignment": ("model", "replica"),
    "assignment_epoch": ("model", "replica", "version"),
    "redeem": ("model", "replica", "*", "op_id"),
    "source_progress": ("model", "source_replica", "version"),
    "shard_progress": ("model", "source_replica", "version", "shard_idx"),
    "list_versions": ("model",),
    "latest": ("model",),
    "num_shards": ("model",),
    "replica_version": ("model", "replica"),
    "manifest": ("model", "version", "shard_idx", "*", "num_shards"),
    "replica_manifest": ("model", "version", "replica", "shard_idx"),
    "replica_datacenter": ("model", "replica"),
    "availability": ("model", "version"),
    "metrics": (),
    "metrics_text": (),
    "config": (),
    # administrative: kill this controller (tests / chaos drills); not
    # logged — a crash is precisely the thing the WAL does not record
    "crash": (),
}

#: every server method a transport may dispatch to, mutating or not
CONTROL_OPS: Set[str] = set(OP_SCHEMAS) | set(READONLY_OPS)

# ---------------------------------------------------------------------------
# Replica/version state
# ---------------------------------------------------------------------------

IN_PROGRESS = "in_progress"
PUBLISHED = "published"
DRAINING = "draining"

KIND_GPU = "gpu"
KIND_OFFLOAD = "offload"


@dataclasses.dataclass
class ReplicaVersionState:
    """One replica's relationship to one version."""

    replica: str
    version: int
    kind: str = KIND_GPU
    status: str = PUBLISHED
    #: per-shard count of transfer units received (pipeline progress, 4.3.3)
    progress: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: replication sessions this replica currently serves (load balancing)
    refcount: int = 0
    #: for in-progress replicas: the source replica currently assigned
    source: Optional[str] = None
    #: True while this replica fetches over the slow cross-DC link (4.3.4)
    seeding: bool = False
    #: pipeline-chain depth from the original publisher (0 = published
    #: directly). Used by the beyond-paper "depth_aware" scheduler: a
    #: shallow replication tree cuts the pipeline fill latency that a pure
    #: least-loaded policy (which degenerates into a chain) pays.
    depth: int = 0
    #: offload replica created for *cross-DC seeding* (released once a local
    #: GPU replica has consumed it), vs a retention offload (released once it
    #: is no longer the last copy / no longer retained)
    seed_cache: bool = False
    #: shards that called complete_replicate
    completed_shards: Set[int] = dataclasses.field(default_factory=set)
    #: for in-progress replicas: the multi-source read plan as ordered
    #: (source replica, start_unit, stop_unit) ranges; ``source`` above is
    #: always the plan's primary (first) entry
    plan: List[Tuple[str, int, int]] = dataclasses.field(default_factory=list)
    #: bumped whenever the plan is (re)partitioned; readers poll it
    assign_epoch: int = 0
    #: this replica *as a source*: per-shard count of active readers
    shard_readers: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: snapshot of the version's source generation when the plan was built
    #: (work stealing: a reader's progress report re-partitions only when a
    #: source arrived since — an O(1) check on the hot path)
    plan_gen: int = 0
    #: swarm replication: set once this in-progress replica's completed
    #: prefix (min over shards) first becomes non-empty — the moment it
    #: enters the unit-granular availability map as a servable source.
    #: The announcement bumps the version's source generation exactly
    #: once, so readers re-scan the pool without per-report churn.
    swarm_announced: bool = False

    def is_source_candidate(self) -> bool:
        return self.status in (PUBLISHED, IN_PROGRESS)


@dataclasses.dataclass
class ReplicaInfo:
    """An open replica (model-parallel group) and its placement."""

    name: str
    num_shards: int
    datacenter: str
    is_spot: bool
    kind: str = KIND_GPU
    #: retention lag: keep versions [latest-retain .. latest] available (3.3)
    retain: Optional[int] = None
    workers: Dict[int, WorkerInfo] = dataclasses.field(default_factory=dict)
    open_shards: Set[int] = dataclasses.field(default_factory=set)
    last_heartbeat: Dict[int, float] = dataclasses.field(default_factory=dict)
    #: version currently held (published/in-progress), None if unpublished
    current_version: Optional[int] = None
    #: old versions awaiting drain (refcount->0) and/or offload completion;
    #: maps version -> offload_pending
    draining: Dict[int, bool] = dataclasses.field(default_factory=dict)
    registered: Set[int] = dataclasses.field(default_factory=set)
    failed: bool = False
    #: gray-failure classifier state (4.5 extension): strikes accumulate
    #: from transient/corrupt transfer-failure evidence; at the quarantine
    #: threshold the replica is benched as a *source* (still alive, still
    #: registered, still a pull destination) until the probation deadline.
    #: Wire-registered dataclass fields, so the op log digest and failover
    #: replay carry them automatically.
    suspect_strikes: int = 0
    quarantined_until: Optional[float] = None
    #: delta-transfer bookkeeping: the most recent version this replica
    #: fully held before retiring it (set at unpublish / update start).
    #: A destination with ``prior_version == v`` still holds v's bytes
    #: (and its store snapshotted them), so a source whose own
    #: ``prior_version`` matches can serve int8 residuals instead of the
    #: full payload. Wire-registered, so failover replay carries it.
    prior_version: Optional[int] = None


@dataclasses.dataclass
class _Txn:
    op: str
    args_repr: str
    result: Any
    arrived: Set[int]
    on_last: Optional[Callable[[], None]] = None


#: retired group ops remembered per replica for idempotent re-delivery: a
#: client retrying after a controller failover (at-most-once ambiguity —
#: the crash may have landed between execute and reply) re-sends its most
#: recent ops; the memory hands back the cached result instead of
#: re-running them. Shards issue ops in lockstep program order, so a
#: retry is always among the last few op ids.
DONE_TXN_MEMORY = 8


@dataclasses.dataclass
class _PendingReplicate:
    """A replicate() group parked until its version spec resolves."""

    replica: str
    op_id: int
    spec: version_lib.VersionSpec
    assignment: Optional["Assignment"] = None


@dataclasses.dataclass
class ModelState:
    name: str
    num_shards: Optional[int] = None
    latest: Optional[int] = None
    replicas: Dict[str, ReplicaInfo] = dataclasses.field(default_factory=dict)
    #: version -> replica name -> state
    versions: Dict[int, Dict[str, ReplicaVersionState]] = dataclasses.field(
        default_factory=dict
    )
    #: per-shard manifests per version, keyed by (layout, shard_idx) where
    #: *layout* is the replica's shard count — replicas with different
    #: layouts register their own manifest families, and cross-layout
    #: readers fetch the source family to build a reshard plan. The
    #: family holds the FIRST layout registered at that shard count;
    #: a same-count replica sharded along different axes is tracked only
    #: in ``replica_manifests`` (below), which is alias-free.
    manifests: Dict[int, Dict[Tuple[int, int], ShardManifest]] = dataclasses.field(
        default_factory=dict
    )
    #: exact per-replica manifests, keyed by (replica_name, shard_idx).
    #: Readers resolve their assigned *source replica* here (falling back
    #: to its count family), so two same-count layouts can coexist on one
    #: version without unit pulls silently crossing layouts.
    replica_manifests: Dict[int, Dict[Tuple[str, int], ShardManifest]] = (
        dataclasses.field(default_factory=dict)
    )
    txns: Dict[Tuple[str, int], _Txn] = dataclasses.field(default_factory=dict)
    #: retired group ops, (replica, op_id) -> completed txn (result cached,
    #: on_last dropped); bounded to DONE_TXN_MEMORY per replica
    done_txns: Dict[Tuple[str, int], _Txn] = dataclasses.field(default_factory=dict)
    pending: List[_PendingReplicate] = dataclasses.field(default_factory=list)
    #: per-version source generation: bumped whenever a replica finishes
    #: holding the version (publish of the last shard / completed
    #: replication) — i.e. whenever the multi-source candidate pool grew
    source_gen: Dict[int, int] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Results returned to clients
# ---------------------------------------------------------------------------


# ``SourceSlice`` and ``Assignment`` live in ``repro_torch.core.meta`` (they are
# plan *metadata*, shared by both data planes); re-exported here for the
# historical import path. ``SourceSlice.ceiling`` carries each source's
# progress ceiling — the swarm-replication contract that lets in-progress
# replicas serve exactly their completed prefix.


@dataclasses.dataclass(frozen=True)
class PublishResult:
    version: int


@dataclasses.dataclass(frozen=True)
class UnpublishResult:
    #: client must first offload its shard to CPU and publish_offload (3.3)
    offload_required: bool
    offload_version: Optional[int] = None
    #: True once the replica is hidden and drained; if False the client must
    #: poll wait_drained() before mutating buffers (3.2 mutability contract)
    drained: bool = True


@dataclasses.dataclass(frozen=True)
class UpdateDecision:
    updated: bool
    reason: str = ""
    version: Optional[int] = None
    assignment: Optional[Assignment] = None
    #: retention: offload the *current* version before reusing buffers
    offload_required: bool = False
    offload_version: Optional[int] = None
    drained: bool = True
    #: offload seeding (4.3.4): this caller must run the background fetch
    seed_started: bool = False
    seed_version: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str  # "offload_release" | "evicted"
    model: str
    replica: str
    version: Optional[int] = None
    reason: str = ""


class ReferenceServer:
    """Centralized reference server. See module docstring."""

    def __init__(
        self,
        *,
        heartbeat_timeout: Optional[float] = None,
        pipeline_replication: bool = True,
        smart_skipping: bool = True,
        scheduler: str = "least_loaded",  # paper 4.3.1 | "depth_aware" (beyond-paper)
        # "pinned" pins every reader to the first candidate by name — the
        # naive-broadcast baseline benchmarks compare against
        max_sources: int = 4,
        work_stealing: bool = True,
        chunk_hint: Optional[float] = None,
        swarm: bool = True,
        wan_codec: str = "int8",
        wan_delta: bool = True,
        quarantine_threshold: int = 3,
        quarantine_probation: float = 30.0,
        log: Optional[OpLog] = None,
    ) -> None:
        self._models: Dict[str, ModelState] = {}
        self._heartbeat_timeout = heartbeat_timeout
        self._pipeline = pipeline_replication
        self._smart_skipping = smart_skipping
        self._scheduler = scheduler
        #: max replicas a multi-source assignment partitions units across;
        #: 1 disables multi-source planning entirely (legacy single source)
        self._max_sources = max(1, max_sources)
        self._work_stealing = work_stealing
        #: the data plane's sub-unit chunk threshold, used as the "giant
        #: unit" hint when choosing between pipeline chaining and
        #: published-pool partitioning (see _plan_assignment)
        self._chunk_hint = (
            meta_defaults.DEFAULT_CHUNK_BYTES if chunk_hint is None else chunk_hint
        )
        #: wire codec negotiated for WAN-crossing (cross-DC) slices; the
        #: resolve validates the name at construction so a bad knob fails
        #: here, not mid-transfer. Intra-DC links and resharded interval
        #: reads always negotiate "raw" (see _make_assignment). Imported
        #: lazily: repro_torch.transfer.codec depends on repro_torch.core.meta, so a
        #: module-level import would close an import cycle.
        from repro_torch.transfer.codec import get_codec

        get_codec(wan_codec)
        self._wan_codec = wan_codec
        #: delta negotiation: when a WAN-crossing slice's source and
        #: destination both retired the same prior version (tracked on
        #: ``ReplicaInfo.prior_version``), negotiate
        #: ``delta:<wan_codec>`` — the source ships int8 residuals
        #: against the base both sides still hold. Only meaningful for
        #: base codecs the delta framing supports; other wan_codecs
        #: (e.g. ``fixed:<r>``) silently negotiate plain.
        self._wan_delta = bool(wan_delta)
        if self._wan_delta and wan_codec in ("raw", "int8"):
            get_codec(f"delta:{wan_codec}")
        #: swarm replication: admit *in-progress* replicas into the
        #: multi-source pool for the prefix of units they have completed
        #: (unit-granular availability map). ``swarm=False`` reproduces
        #: the pre-swarm (PR 2) scheduler bit-for-bit — the knob the
        #: benchmarks use for before/after parity. Swarm planning also
        #: requires pipeline replication (a partial replica serving its
        #: prefix *is* a pipeline relay) and ``max_sources > 1``.
        self._swarm = swarm
        #: gray-failure classifier: transient evidence accumulates strikes
        #: per source; at the threshold the source is quarantined (benched
        #: from planning, not evicted) for the probation window. Corrupt
        #: evidence quarantines immediately. See report_transfer_failure.
        self._quarantine_threshold = max(1, quarantine_threshold)
        self._quarantine_probation = quarantine_probation
        self._events: Dict[str, List[Event]] = {}
        self._watchers: List[Callable[[], None]] = []
        self._seq = 0
        self.stats: Dict[str, int] = {
            "publishes": 0,
            "replications_started": 0,
            "replications_completed": 0,
            "offloads": 0,
            "offload_releases": 0,
            "reassignments": 0,
            "evictions": 0,
            "smart_skips": 0,
            "multi_source_assignments": 0,
            "work_steals": 0,
            "swarm_assignments": 0,
            "swarm_grows": 0,
            "transient_reports": 0,
            "corrupt_reports": 0,
            "quarantines": 0,
            "probation_lifts": 0,
            # delta negotiation: logged assignments that carried at least
            # one delta slice / degraded a would-be-lossy cross-layout
            # slice to raw at plan time because the source payload is
            # wholly non-quantizable (quantizing would frame everything
            # passthrough for zero wire gain)
            "delta_assignments": 0,
            "codec_degrades": 0,
        }
        #: wall-clock duration of the last failover recovery that built
        #: this server (set by ``repro_torch.core.failover.recover``; 0.0 for a
        #: server that never went through recovery). Exposed as a metrics
        #: *gauge*: wall-clock values are intentionally outside the
        #: replayed state digest / counter-equality contract.
        self.last_recovery_s = 0.0
        #: fault tolerance: replayable op log (None = PR 3 behavior,
        #: bit-for-bit — nothing is recorded, nothing can be recovered)
        self._dead = False
        self._log: Optional[OpLog] = None
        if log is not None:
            log.set_config(self.config())
            self._log = log

    # -- fault tolerance: op logging, crash, recovery hooks -------------------

    def config(self) -> Dict[str, Any]:
        """The construction knobs (resolved), as recorded in the op log —
        recovery rebuilds the server from exactly these."""
        return {
            "heartbeat_timeout": self._heartbeat_timeout,
            "pipeline_replication": self._pipeline,
            "smart_skipping": self._smart_skipping,
            "scheduler": self._scheduler,
            "max_sources": self._max_sources,
            "work_stealing": self._work_stealing,
            "chunk_hint": self._chunk_hint,
            "swarm": self._swarm,
            "wan_codec": self._wan_codec,
            "wan_delta": self._wan_delta,
            "quarantine_threshold": self._quarantine_threshold,
            "quarantine_probation": self._quarantine_probation,
        }

    @property
    def log(self) -> Optional[OpLog]:
        return self._log

    def attach_log(self, log: Optional[OpLog]) -> None:
        """Attach (or detach) the op log without writing a config header —
        used by recovery after replaying, so subsequent ops keep
        appending where the crashed server left off."""
        self._log = log

    def crash(self) -> None:
        """Kill the controller: every subsequent call raises
        :class:`ServerUnavailableError` until clients fail over to a
        recovered server (``repro_torch.core.failover.recover``). In-flight
        calls that already passed the liveness check complete against the
        dead server's (discarded) state — the at-most-once ambiguity the
        idempotent op layer absorbs on retry."""
        self._dead = True

    @property
    def is_crashed(self) -> bool:
        return self._dead

    def _check_alive(self) -> None:
        if self._dead:
            raise ServerUnavailableError(
                "reference server is down; fail over to the recovered server"
            )

    def _record(self, op: str, *args: Any) -> None:
        """WAL-style intent record: appended before the mutation runs, so
        a mid-op crash replays the op to completion (never a torn state).
        Args are positional, in ``oplog.OP_SCHEMAS[op]`` order (= the
        method signature) — the hot path never builds a kwargs dict."""
        log = self._log
        if log is not None:
            log.append(op, args)

    # -- notification plumbing ------------------------------------------------

    def add_watcher(self, cb: Callable[[], None]) -> None:
        """cb() fires after every state mutation (used to wake waiters)."""
        self._watchers.append(cb)

    @property
    def seq(self) -> int:
        return self._seq

    def _bump(self) -> None:
        self._seq += 1
        for cb in self._watchers:
            cb()

    def _emit(self, worker_id: str, ev: Event) -> None:
        self._events.setdefault(worker_id, []).append(ev)

    def poll_events(self, worker_id: str) -> List[Event]:
        self._check_alive()
        # logged only when the pop actually mutates — clients poll this
        # after every op, and recording empty polls would bloat the log
        # with no-ops (skipping them is trivially replay-equivalent).
        # Replay then drains the same queues. A recovered-from-older-log
        # server may re-deliver events a client already saw; client-side
        # handling is idempotent (regression-tested), so re-delivery is
        # a no-op, not a bug.
        if worker_id in self._events:
            self._record("poll_events", worker_id)
        return self._events.pop(worker_id, [])

    # -- lifecycle ------------------------------------------------------------

    def open(
        self,
        model: str,
        replica: str,
        num_shards: int,
        shard_idx: int,
        *,
        worker: WorkerInfo,
        retain: Optional[version_lib.VersionSpec] = None,
    ) -> None:
        self._check_alive()
        self._record("open", model, replica, num_shards, shard_idx, worker, retain)
        st = self._models.setdefault(model, ModelState(name=model))
        if st.num_shards is None:
            # canonical layout = the first opener's; replicas with other
            # shard counts are welcome — mismatched-but-convertible layouts
            # are served by the resharding data plane (repro_torch.resharding),
            # with convertibility checked against layout descriptors at
            # replicate time rather than rejected here.
            st.num_shards = num_shards
        info = st.replicas.get(replica)
        if info is None or info.failed:
            retain_lag = (
                None if retain is None else version_lib.parse_relative(str(retain))
                if isinstance(retain, str)
                else int(retain)
            )
            info = ReplicaInfo(
                name=replica,
                num_shards=num_shards,
                datacenter=worker.datacenter,
                is_spot=worker.is_spot,
                retain=retain_lag,
            )
            st.replicas[replica] = info
        if worker.datacenter != info.datacenter:
            raise ShardLayoutError(
                f"replica {replica!r} spans datacenters "
                f"({info.datacenter} vs {worker.datacenter})"
            )
        if shard_idx in info.open_shards:
            raise ConsistencyError(f"{replica}/shard{shard_idx} opened twice")
        info.workers[shard_idx] = worker
        info.open_shards.add(shard_idx)
        info.last_heartbeat[shard_idx] = 0.0
        self._bump()

    def register(self, model: str, replica: str, shard_idx: int) -> None:
        self._check_alive()
        self._record("register", model, replica, shard_idx)
        info = self._replica(model, replica)
        info.registered.add(shard_idx)
        self._bump()

    def unregister(self, model: str, replica: str, shard_idx: int) -> None:
        self._check_alive()
        self._record("unregister", model, replica, shard_idx)
        info = self._replica(model, replica)
        if info.current_version is not None:
            raise MutabilityViolationError(
                f"{replica}: unregister while version "
                f"{info.current_version} is still published"
            )
        info.registered.discard(shard_idx)
        self._bump()

    def close(self, model: str, replica: str, shard_idx: int) -> None:
        self._check_alive()
        self._record("close", model, replica, shard_idx)
        st = self._model(model)
        info = st.replicas.get(replica)
        if info is None:
            return
        info.open_shards.discard(shard_idx)
        if not info.open_shards:
            self._remove_replica(st, replica, reason="closed")
        self._bump()

    # -- heartbeats / failure detection (4.5) ----------------------------------

    def heartbeat(self, model: str, replica: str, shard_idx: int, now: float) -> None:
        self._check_alive()
        # logged (time enters as an explicit argument, so replay is
        # deterministic): unlogged heartbeats would make replayed tick()
        # evict different replicas than the live run did
        self._record("heartbeat", model, replica, shard_idx, now)
        st = self._models.get(model)
        if st is None:
            return
        info = st.replicas.get(replica)
        if info is None or info.failed:
            raise StaleHandleError(f"{replica} was evicted")
        info.last_heartbeat[shard_idx] = now

    def tick(self, now: float) -> List[str]:
        """Expire heartbeats and lift expired quarantines; returns names
        of replicas evicted this tick."""
        self._check_alive()
        self._record("tick", now)
        evicted: List[str] = []
        lifted = False
        for st in self._models.values():
            # probation: an expired quarantine rejoins the source pools one
            # strike short of the threshold — a single further transient
            # report re-quarantines it (probation, not a clean slate)
            for info in st.replicas.values():
                if info.quarantined_until is not None and now >= info.quarantined_until:
                    info.quarantined_until = None
                    info.suspect_strikes = self._quarantine_threshold - 1
                    self.stats["probation_lifts"] += 1
                    lifted = True
            if self._heartbeat_timeout is None:
                continue
            for name, info in list(st.replicas.items()):
                if info.failed or not info.open_shards:
                    continue
                stale = any(
                    now - info.last_heartbeat.get(s, 0.0) > self._heartbeat_timeout
                    for s in info.open_shards
                )
                if stale:
                    self._fail_replica(st, name, reason="heartbeat timeout")
                    evicted.append(name)
        if evicted or lifted:
            self._bump()
        return evicted

    def fail_replica(self, model: str, replica: str, reason: str = "injected") -> None:
        """Administrative/forced eviction (spot preemption, tests)."""
        self._check_alive()
        self._record("fail_replica", model, replica, reason)
        st = self._model(model)
        if replica in st.replicas:
            self._fail_replica(st, replica, reason=reason)
            self._bump()

    def report_transfer_failure(
        self,
        model: str,
        dest_replica: str,
        source_replica: str,
        evidence: str = "fatal",
        now: float = 0.0,
    ) -> None:
        """A reader reported trouble with its source mid-transfer (4.5).

        ``evidence`` classifies the report instead of treating every one
        as a death sentence:

        * ``"fatal"`` — the source is gone (dead store, stale handle):
          evict and reassign, the original fail-stop behavior.
        * ``"transient"`` — the read flaked or timed out: one strike.
          At ``quarantine_threshold`` strikes the source is *quarantined*
          — benched from source planning for ``quarantine_probation``
          seconds but neither evicted nor unregistered, so a gray-but-
          alive replica keeps its data and its pull-destination role.
        * ``"corrupt"`` — checksum-rejected bytes: quarantined
          immediately (a full threshold of strikes at once).

        The reader resumes from its progress either way; ``_reassign``
        re-plans any in-progress pull whose plan touches the suspect."""
        self._check_alive()
        self._record(
            "report_transfer_failure", model, dest_replica, source_replica,
            evidence, now,
        )
        st = self._model(model)
        info = st.replicas.get(source_replica)
        if evidence == "fatal":
            if info is not None and not info.failed:
                self._fail_replica(st, source_replica, reason="reported by reader")
        elif info is not None and not info.failed:
            if evidence == "corrupt":
                self.stats["corrupt_reports"] += 1
                info.suspect_strikes += self._quarantine_threshold
            else:
                self.stats["transient_reports"] += 1
                info.suspect_strikes += 1
            if info.suspect_strikes >= self._quarantine_threshold:
                until = now + self._quarantine_probation
                if info.quarantined_until is None:
                    self.stats["quarantines"] += 1
                    info.quarantined_until = until
                else:
                    info.quarantined_until = max(info.quarantined_until, until)
        self._reassign(st, dest_replica)
        self._bump()

    def get_assignment(self, model: str, replica: str) -> Optional[Assignment]:
        """Current source assignment for an in-progress replica (may have
        been re-routed after a failure). Works for GPU replicas and offload
        seeding twins alike."""
        self._check_alive()
        st = self._model(model)
        info = st.replicas.get(replica)
        if info is None or info.failed:
            raise StaleHandleError(f"{replica} was evicted")
        for vmap in st.versions.values():
            rv = vmap.get(replica)
            if rv is None or rv.status != IN_PROGRESS or rv.source is None:
                continue
            src_state = vmap.get(rv.source)
            if src_state is None:
                return None  # source died; awaiting _reassign
            return self._make_assignment(
                st, rv.version, src_state, dest=info,
                plan=rv.plan or None, epoch=rv.assign_epoch,
            )
        return None

    def assignment_epoch(self, model: str, replica: str, version: int) -> int:
        """Current plan revision of an in-progress replica. Readers compare
        this against their Assignment's epoch between unit flows: a bump
        means the plan was re-partitioned (source death, work stealing) and
        the reader should re-fetch its assignment."""
        self._check_alive()
        st = self._model(model)
        rv = st.versions.get(version, {}).get(replica)
        if rv is None:
            raise StaleHandleError(f"{replica} no longer replicating v{version}")
        return rv.assign_epoch

    # -- write path -----------------------------------------------------------

    def publish(
        self,
        model: str,
        replica: str,
        shard_idx: int,
        version: int,
        manifest: ShardManifest,
        *,
        op_id: int,
    ) -> PublishResult:
        self._check_alive()
        self._record("publish", model, replica, shard_idx, version, manifest, op_id)
        st = self._model(model)
        info = self._replica(model, replica)
        if shard_idx not in info.registered:
            raise MutabilityViolationError(
                f"{replica}/shard{shard_idx}: publish before register"
            )

        def on_first() -> PublishResult:
            if info.current_version is not None:
                raise MutabilityViolationError(
                    f"{replica}: publish({version}) while version "
                    f"{info.current_version} is still published; unpublish first"
                )
            self._install_replica_version(
                st, info, version, status=PUBLISHED, kind=info.kind
            )
            self.stats["publishes"] += 1
            self._advance_latest(st, version)
            return PublishResult(version=version)

        res = self._group_op(
            st, info, shard_idx, op_id, "publish", repr(version), on_first
        )
        # per-shard manifest registration (data-plane visibility); written
        # to be idempotent — a retried publish (controller failover
        # at-most-once ambiguity) must not bump the source generation or
        # resurrect a since-dropped version
        rv = st.versions.get(version, {}).get(replica)
        if rv is not None:
            self._set_manifest(
                st, version, replica, info.num_shards, shard_idx, manifest
            )
            was_full = len(rv.progress) >= info.num_shards
            rv.progress[shard_idx] = manifest.num_units
            if not was_full and len(rv.progress) >= info.num_shards:
                # fully published: the multi-source candidate pool grew
                st.source_gen[version] = st.source_gen.get(version, 0) + 1
        self._service_pending(st)
        self._bump()
        return res

    def publish_offload(
        self,
        model: str,
        replica: str,
        shard_idx: int,
        version: int,
        manifest: ShardManifest,
        *,
        op_id: int,
    ) -> PublishResult:
        """Publish the CPU offload copy created by the retention protocol or
        by offload seeding (3.3, 4.3.4)."""
        self._check_alive()
        self._record(
            "publish_offload", model, replica, shard_idx, version, manifest, op_id
        )
        st = self._model(model)
        info = self._replica(model, replica)
        off_name = offload_name(replica)

        def on_first() -> PublishResult:
            offinfo = st.replicas.get(off_name)
            if offinfo is None:
                offinfo = ReplicaInfo(
                    name=off_name,
                    num_shards=info.num_shards,
                    datacenter=info.datacenter,
                    is_spot=info.is_spot,
                    kind=KIND_OFFLOAD,
                    workers=dict(info.workers),
                    open_shards=set(info.open_shards),
                )
                st.replicas[off_name] = offinfo
            self._install_replica_version(
                st, offinfo, version, status=PUBLISHED, kind=KIND_OFFLOAD
            )
            self.stats["offloads"] += 1
            return PublishResult(version=version)

        res = self._group_op(
            st, info, shard_idx, op_id, "publish_offload", repr(version), on_first
        )
        off_rv = st.versions.get(version, {}).get(off_name)
        if off_rv is not None:  # tolerate re-delivery after the copy dropped
            self._set_manifest(
                st, version, off_name, info.num_shards, shard_idx, manifest
            )
            off_rv.progress[shard_idx] = manifest.num_units
        if info.draining.get(version):
            info.draining[version] = False  # retention satisfied by the offload copy
        self._service_pending(st)
        self._bump()
        return res

    def unpublish(
        self, model: str, replica: str, shard_idx: int, *, op_id: int
    ) -> UnpublishResult:
        self._check_alive()
        self._record("unpublish", model, replica, shard_idx, op_id)
        st = self._model(model)
        info = self._replica(model, replica)

        def on_first() -> UnpublishResult:
            return self._begin_unpublish(st, info)

        res = self._group_op(
            st, info, shard_idx, op_id, "unpublish", "", on_first
        )
        self._bump()
        return res

    def finish_unpublish(self, model: str, replica: str) -> bool:
        """Poll step after unpublish: returns True once every draining
        version of this replica has (a) zero in-flight readers and (b) its
        required offload published. Only then may the client reuse the
        weight buffers (3.2 mutability contract)."""
        self._check_alive()
        st = self._model(model)
        info = self._replica(model, replica)
        # logged only when a drain is actually outstanding: this is a
        # 20ms polling call (clients spin on it while readers drain),
        # and with nothing draining it provably mutates nothing — the
        # log records state changes, not poll frequency
        if info.draining:
            self._record("finish_unpublish", model, replica)
        for v in list(info.draining.keys()):
            offload_pending = info.draining[v]
            rv = st.versions.get(v, {}).get(replica)
            if rv is None:
                if not offload_pending:
                    del info.draining[v]
                continue
            if rv.refcount == 0 and not offload_pending:
                self._drop_replica_version(st, replica, v)
                del info.draining[v]
        done = not info.draining
        if done:
            self._bump()
        return done

    # -- read path ------------------------------------------------------------

    def begin_replicate(
        self,
        model: str,
        replica: str,
        shard_idx: int,
        spec: version_lib.VersionSpec,
        *,
        op_id: int,
    ) -> Optional[Assignment]:
        """Start (or park) a blocking replicate(). Returns the group's
        Assignment, or None if the version does not exist yet — in which
        case the group is parked and must poll :meth:`redeem`."""
        self._check_alive()
        self._record("begin_replicate", model, replica, shard_idx, spec, op_id)
        st = self._model(model)
        info = self._replica(model, replica)

        def on_first() -> Optional[Assignment]:
            if info.current_version is not None:
                raise MutabilityViolationError(
                    f"{replica}: replicate while holding version "
                    f"{info.current_version}; use update() or unpublish first"
                )
            v = version_lib.resolve(spec, st.latest)
            if v is not None and self._find_source(st, v, info) is not None:
                return self._assign(st, info, v)
            pend = _PendingReplicate(replica=replica, op_id=op_id, spec=spec)
            st.pending.append(pend)
            return None

        res = self._group_op(
            st, info, shard_idx, op_id, "replicate", repr(spec), on_first
        )
        self._bump()
        return res

    def redeem(self, model: str, replica: str, *, op_id: int) -> Optional[Assignment]:
        """Check whether a parked replicate() has been assigned."""
        self._check_alive()
        st = self._model(model)
        info = st.replicas.get(replica)
        if info is None or info.failed:
            raise StaleHandleError(f"{replica} was evicted")
        for p in st.pending:
            if p.replica == replica and p.op_id == op_id:
                return p.assignment  # still parked (None) — keep waiting
        # no longer parked: assignment was delivered through txn state
        txn = st.txns.get((replica, op_id))
        if txn is not None and isinstance(txn.result, Assignment):
            return txn.result
        cur = self._current_state(st, replica)
        if cur is not None and cur.status == IN_PROGRESS and cur.source:
            src = st.versions[cur.version].get(cur.source)
            if src is not None:
                return self._make_assignment(
                    st, cur.version, src, dest=info,
                    plan=cur.plan or None, epoch=cur.assign_epoch,
                )
        return None

    def begin_update(
        self,
        model: str,
        replica: str,
        shard_idx: int,
        spec: version_lib.VersionSpec,
        *,
        op_id: int,
        offload_seeding: bool = False,
    ) -> UpdateDecision:
        """Atomic check-and-transition to a newer version (Table 2 update)."""
        self._check_alive()
        self._record(
            "begin_update", model, replica, shard_idx, spec, op_id, offload_seeding
        )
        st = self._model(model)
        info = self._replica(model, replica)

        def on_first() -> UpdateDecision:
            v = version_lib.resolve(spec, st.latest)
            if v is None:
                return UpdateDecision(updated=False, reason="no such version")
            if info.current_version == v:
                return UpdateDecision(updated=False, reason="already current")
            src = self._find_source(st, v, info)
            if src is None:
                return UpdateDecision(updated=False, reason="no live source")
            # Smart skipping (4.3.4): if the only local path to v is a replica
            # still seeding over TCP, treat v as temporarily unavailable.
            if self._smart_skipping and self._only_seeding_sources(st, v, info):
                self.stats["smart_skips"] += 1
                started = offload_seeding and self._ensure_offload_seed(st, v, info)
                return UpdateDecision(
                    updated=False,
                    reason="seeding in progress",
                    seed_started=started,
                    seed_version=v if started else None,
                )
            if (
                offload_seeding
                and src.kind != KIND_OFFLOAD
                and self._cross_dc(st, src, info)
            ):
                # No local source at all: seed through a CPU buffer in the
                # background instead of stalling the accelerator (4.3.4).
                started = self._ensure_offload_seed(st, v, info)
                return UpdateDecision(
                    updated=False,
                    reason="offload seeding started"
                    if started
                    else "offload seeding in progress",
                    seed_started=started,
                    seed_version=v if started else None,
                )
            # commit: unpublish current (retention-aware), then assign.
            unpub = UnpublishResult(offload_required=False)
            if info.current_version is not None:
                unpub = self._begin_unpublish(st, info)
            assignment = self._assign(st, info, v)
            return UpdateDecision(
                updated=True,
                version=v,
                assignment=assignment,
                offload_required=unpub.offload_required,
                offload_version=unpub.offload_version,
                drained=unpub.drained,
            )

        res = self._group_op(
            st, info, shard_idx, op_id, "update", repr(spec), on_first
        )
        self._bump()
        return res

    def source_progress(self, model: str, source_replica: str, version: int) -> int:
        """Min over shards of the source's progress counter. Readers poll
        this (in the real system it is a one-sided read on the source)."""
        self._check_alive()
        st = self._model(model)
        vmap = st.versions.get(version, {})
        rv = vmap.get(source_replica)
        if rv is None:
            raise StaleHandleError(f"source {source_replica} no longer holds v{version}")
        if not rv.progress:
            return 0
        return min(rv.progress.values())

    def shard_progress(self, model: str, source_replica: str, version: int, shard_idx: int) -> int:
        self._check_alive()
        st = self._model(model)
        rv = st.versions.get(version, {}).get(source_replica)
        if rv is None:
            raise StaleHandleError(f"source {source_replica} no longer holds v{version}")
        return rv.progress.get(shard_idx, 0)

    def update_progress(
        self, model: str, replica: str, shard_idx: int, version: int, progress: int
    ) -> None:
        self._check_alive()
        self._record("update_progress", model, replica, shard_idx, version, progress)
        st = self._model(model)
        rv = st.versions.get(version, {}).get(replica)
        if rv is None:
            raise StaleHandleError(f"{replica} no longer replicating v{version}")
        rv.progress[shard_idx] = max(rv.progress.get(shard_idx, 0), progress)
        # swarm announcement: the first time this puller's completed prefix
        # (min over shards) becomes non-empty it joins the availability map
        # as a servable source; bump the source generation once so other
        # readers' progress reports re-scan the pool and grow their plans.
        if (
            self._swarm
            and rv.status == IN_PROGRESS
            and not rv.swarm_announced
            and rv.progress
            and min(rv.progress.values()) >= 1
        ):
            rv.swarm_announced = True
            st.source_gen[version] = st.source_gen.get(version, 0) + 1
        # work stealing (driven by reader progress reports): a source that
        # arrived after this plan was built gets a share of the remaining
        # units. The generation check keeps the hot path O(1).
        if (
            self._work_stealing
            and rv.status == IN_PROGRESS
            and rv.plan
            and rv.plan_gen != st.source_gen.get(version, 0)
        ):
            self._steal_work(st, version, rv)
        self._bump()

    def complete_replicate(
        self, model: str, replica: str, shard_idx: int, version: int, *, op_id: int
    ) -> None:
        self._check_alive()
        self._record("complete_replicate", model, replica, shard_idx, version, op_id)
        st = self._model(model)
        info = self._replica(model, replica)
        rv = st.versions.get(version, {}).get(replica)
        if rv is None:
            if (info.name, op_id) in st.done_txns:
                # the whole group already completed and the version has
                # since been dropped: a re-delivered complete is a no-op
                self._group_op(
                    st, info, shard_idx, op_id, "complete", repr(version),
                    lambda: None,
                )
                return
            raise StaleHandleError(f"{replica} lost its in-progress state for v{version}")
        rv.completed_shards.add(shard_idx)
        self._group_op(
            st,
            info,
            shard_idx,
            op_id,
            "complete",
            repr(version),
            lambda: None,
            self._complete_on_last(st, version, replica),
        )
        self._bump()

    def _complete_on_last(
        self, st: ModelState, version: int, replica: str
    ) -> Callable[[], None]:
        """The group-completion action of complete_replicate, as a factory
        so snapshot restore can rebuild the callback for an open txn (the
        closure binds only replayable state, never the live objects).
        Idempotent: a re-run against an already-published replica (dup
        delivery after failover) changes nothing."""

        def on_last() -> None:
            rv = st.versions.get(version, {}).get(replica)
            if rv is None or rv.status != IN_PROGRESS:
                return  # already completed (or dropped): nothing to do
            rv.status = PUBLISHED
            rv.seeding = False
            self._release_sources(st.versions.get(version, {}), rv)
            self.stats["replications_completed"] += 1
            # this replica is now a fully-held copy: late readers steal from it
            st.source_gen[version] = st.source_gen.get(version, 0) + 1
            self._maybe_release_offloads(st, version)
            self._service_pending(st)

        return on_last

    # -- queries (Table 2: list / wait) ----------------------------------------

    def list_versions(self, model: str) -> Dict[int, Set[str]]:
        self._check_alive()
        st = self._models.get(model)
        if st is None:
            return {}
        out: Dict[int, Set[str]] = {}
        for v, vmap in st.versions.items():
            names = {
                r.replica
                for r in vmap.values()
                if r.status == PUBLISHED or (r.status == IN_PROGRESS)
            }
            if names:
                out[v] = names
        return out

    def latest(self, model: str) -> Optional[int]:
        self._check_alive()
        st = self._models.get(model)
        return None if st is None else st.latest

    def num_shards(self, model: str) -> Optional[int]:
        self._check_alive()
        st = self._models.get(model)
        return None if st is None else st.num_shards

    def replica_version(self, model: str, replica: str) -> Optional[int]:
        """The version a replica currently holds (published or in
        progress), or None for an unknown/evicted/idle replica. Clients
        re-asserting state after a controller failover compare this
        against their local view to decide what to re-issue."""
        self._check_alive()
        st = self._models.get(model)
        if st is None:
            return None
        info = st.replicas.get(replica)
        if info is None or info.failed:
            return None
        return info.current_version

    def manifest(
        self,
        model: str,
        version: int,
        shard_idx: int,
        *,
        num_shards: Optional[int] = None,
    ) -> Optional[ShardManifest]:
        """Manifest of one shard of one layout family; ``num_shards``
        defaults to the model's canonical (first-opened) layout."""
        self._check_alive()
        st = self._model(model)
        layout = st.num_shards if num_shards is None else num_shards
        return st.manifests.get(version, {}).get((layout, shard_idx))

    def put_manifest(
        self,
        model: str,
        replica: str,
        shard_idx: int,
        version: int,
        manifest: ShardManifest,
    ) -> None:
        """Register a manifest for a replica's own layout family.

        Called by cross-layout readers at replicate start so that (a) the
        planner's inputs are server-visible and (b) downstream readers
        with the *same* non-canonical layout can pipeline plain unit
        pulls off this replica's progress counter."""
        self._check_alive()
        self._record("put_manifest", model, replica, shard_idx, version, manifest)
        st = self._model(model)
        info = self._replica(model, replica)
        self._set_manifest(st, version, replica, info.num_shards, shard_idx, manifest)
        self._bump()

    def replica_manifest(
        self, model: str, version: int, replica: str, shard_idx: int
    ) -> Optional[ShardManifest]:
        """The exact manifest a given replica's shard holds for a version,
        falling back to its shard-count family (publishers and same-layout
        chains never diverge from their family). Readers resolve their
        assigned source through this — not through the count family — so
        two same-count layouts on one version cannot alias."""
        self._check_alive()
        return self._replica_manifest(self._model(model), version, replica, shard_idx)

    def _replica_manifest(
        self, st: ModelState, version: int, replica: str, shard_idx: int
    ) -> Optional[ShardManifest]:
        """Unguarded internal lookup: scheduler internals must not trip
        the public liveness check — a crashed server's in-flight op runs
        to completion against its (discarded) state."""
        m = st.replica_manifests.get(version, {}).get((replica, shard_idx))
        if m is not None:
            return m
        info = st.replicas.get(replica)
        layout = st.num_shards if info is None else info.num_shards
        return st.manifests.get(version, {}).get((layout, shard_idx))

    def replica_datacenter(self, model: str, replica: str) -> str:
        self._check_alive()
        return self._replica(model, replica).datacenter

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _model(self, model: str) -> ModelState:
        st = self._models.get(model)
        if st is None:
            raise TensorHubError(f"unknown model {model!r}")
        return st

    def _replica(self, model: str, replica: str) -> ReplicaInfo:
        st = self._model(model)
        info = st.replicas.get(replica)
        if info is None:
            raise TensorHubError(f"unknown replica {replica!r}")
        if info.failed:
            raise StaleHandleError(f"{replica} was evicted")
        return info

    def _group_op(
        self,
        st: ModelState,
        info: ReplicaInfo,
        shard_idx: int,
        op_id: int,
        op: str,
        args_repr: str,
        on_first: Callable[[], Any],
        on_last: Optional[Callable[[], None]] = None,
    ) -> Any:
        """Transactional group op (4.4). First arrival executes; all shards
        consume the same cached result; optional on_last runs when the whole
        group arrived.

        Re-delivery is a no-op: a shard retrying an op after a controller
        failover (the crash may have landed between execute and reply)
        gets the cached result back — from the open txn if the group is
        still gathering, or from the bounded done-txn memory after it
        retired. Only a *divergent* op (same id, different kind or args)
        still raises: that is an SPMD framework bug, not a retry."""
        key = (info.name, op_id)
        done = st.done_txns.get(key)
        if done is not None:
            if done.op != op or done.args_repr != args_repr:
                raise ConsistencyError(
                    f"{info.name} op#{op_id}: shard{shard_idx} issued "
                    f"{op}({args_repr}) but group ran {done.op}({done.args_repr})"
                )
            if isinstance(done.result, TensorHubError):
                raise done.result
            return done.result
        txn = st.txns.get(key)
        if txn is None:
            result = on_first()
            txn = _Txn(
                op=op, args_repr=args_repr, result=result, arrived=set(), on_last=on_last
            )
            st.txns[key] = txn
        else:
            if txn.op != op or txn.args_repr != args_repr:
                raise ConsistencyError(
                    f"{info.name} op#{op_id}: shard{shard_idx} issued "
                    f"{op}({args_repr}) but group ran {txn.op}({txn.args_repr})"
                )
        if shard_idx not in txn.arrived:
            txn.arrived.add(shard_idx)
            if len(txn.arrived) == info.num_shards:
                if txn.on_last is not None:
                    txn.on_last()
                del st.txns[key]
                self._retire_txn(st, info.name, key, txn)
        if isinstance(txn.result, TensorHubError):
            raise txn.result
        return txn.result

    def _retire_txn(
        self, st: ModelState, replica: str, key: Tuple[str, int], txn: _Txn
    ) -> None:
        """Remember a completed group op for idempotent re-delivery,
        pruned to the DONE_TXN_MEMORY most recent op ids per replica
        (shards issue ops in lockstep, so retries are always recent)."""
        st.done_txns[key] = _Txn(
            op=txn.op, args_repr=txn.args_repr, result=txn.result,
            arrived=set(txn.arrived),
        )
        # prune by insertion recency (dicts are insertion-ordered), NOT by
        # op-id magnitude: reassert ops use high-base ids (2M+/3M+) that
        # would otherwise squat the cache forever and evict genuinely
        # recent ops
        mine = [k for k in st.done_txns if k[0] == replica]
        for k in mine[: max(0, len(mine) - DONE_TXN_MEMORY)]:
            del st.done_txns[k]

    # -- publish/unpublish helpers ---------------------------------------------

    def _install_replica_version(
        self,
        st: ModelState,
        info: ReplicaInfo,
        version: int,
        *,
        status: str,
        kind: str,
        source: Optional[str] = None,
        seeding: bool = False,
    ) -> ReplicaVersionState:
        if kind == KIND_GPU:
            if info.current_version is not None:
                raise MutabilityViolationError(
                    f"{info.name} already holds v{info.current_version}"
                )
            info.current_version = version
        rv = ReplicaVersionState(
            replica=info.name,
            version=version,
            kind=kind,
            status=status,
            source=source,
            seeding=seeding,
        )
        st.versions.setdefault(version, {})[info.name] = rv
        return rv

    def _advance_latest(self, st: ModelState, version: int) -> None:
        if st.latest is None or version > st.latest:
            st.latest = version
            # A new latest shifts every retain window: offload replicas pinned
            # only by retention may now be released (3.3).
            for v in list(st.versions.keys()):
                self._maybe_release_offloads(st, v)
            self._gc_versions(st)

    def _retained_versions(self, st: ModelState) -> Set[int]:
        if st.latest is None:
            return set()
        out: Set[int] = set()
        for info in st.replicas.values():
            if info.failed or info.retain is None:
                continue
            for k in range(info.retain + 1):
                v = st.latest - k
                if v >= 0:
                    out.add(v)
        return out

    def _live_copies(self, st: ModelState, version: int, *, exclude: str) -> int:
        """Replicas (any kind) that can keep the version alive; spot-hosted
        replicas do not count toward retention (4.5)."""
        n = 0
        for rv in st.versions.get(version, {}).values():
            if rv.replica == exclude or rv.status != PUBLISHED:
                continue
            if st.replicas[rv.replica].is_spot:
                continue
            n += 1
        return n

    def _begin_unpublish(self, st: ModelState, info: ReplicaInfo) -> UnpublishResult:
        v = info.current_version
        if v is None:
            raise MutabilityViolationError(f"{info.name}: unpublish with nothing published")
        rv = st.versions[v][info.name]
        offload_required = (
            v in self._retained_versions(st)
            and not info.is_spot
            and self._live_copies(st, v, exclude=info.name) == 0
        )
        # hide from the scheduler immediately; mutation must wait for drain
        rv.status = DRAINING
        info.current_version = None
        # delta bookkeeping: this replica just retired v and its store
        # snapshots the bytes — it can serve/receive residuals against v
        # until it next completes a different version
        info.prior_version = v
        if rv.refcount == 0 and not offload_required:
            self._drop_replica_version(st, info.name, v)
            return UnpublishResult(offload_required=False, drained=True)
        # If an offload is required the client performs it *before* reusing
        # buffers; the GPU entry is dropped after offload + drain.
        info.draining[v] = offload_required
        return UnpublishResult(
            offload_required=offload_required,
            offload_version=v if offload_required else None,
            drained=False,
        )

    def _drop_replica_version(self, st: ModelState, replica: str, version: int) -> None:
        vmap = st.versions.get(version)
        if not vmap:
            return
        rv = vmap.pop(replica, None)
        if rv is not None:
            self._release_sources(vmap, rv)
        rep_map = st.replica_manifests.get(version)
        if rep_map:
            for key in [k for k in rep_map if k[0] == replica]:
                del rep_map[key]
        if not vmap:
            del st.versions[version]
            st.manifests.pop(version, None)
            st.replica_manifests.pop(version, None)
            st.source_gen.pop(version, None)
        self._gc_versions(st)

    def _gc_versions(self, st: ModelState) -> None:
        for v in list(st.versions.keys()):
            if not st.versions[v]:
                del st.versions[v]
                st.manifests.pop(v, None)
                st.replica_manifests.pop(v, None)
                st.source_gen.pop(v, None)

    def _maybe_release_offloads(self, st: ModelState, version: int) -> None:
        """Release offload replicas that outlived their purpose (3.3, 4.3.4):

        * retention offloads — once no longer the last copy, or no longer
          retained;
        * seed caches — once a same-DC GPU replica holds the version (it has
          been consumed locally), or a newer version superseded it.
        """
        vmap = st.versions.get(version)
        if not vmap:
            return
        retained = self._retained_versions(st)
        for name, rv in list(vmap.items()):
            if rv.kind != KIND_OFFLOAD or rv.status != PUBLISHED:
                continue
            if rv.refcount > 0:
                continue
            info = st.replicas.get(name)
            if info is None:
                continue
            if rv.seed_cache:
                consumed = any(
                    o.kind == KIND_GPU
                    and o.status == PUBLISHED
                    and st.replicas[o.replica].datacenter == info.datacenter
                    for o in vmap.values()
                )
                superseded = st.latest is not None and version < st.latest
                release = consumed or superseded
            else:
                others = self._live_copies(st, version, exclude=name)
                release = version not in retained or others > 0
            if release:
                self._drop_replica_version(st, name, version)
                self.stats["offload_releases"] += 1
                for w in info.workers.values():
                    self._emit(
                        w.worker_id,
                        Event(
                            kind="offload_release",
                            model=st.name,
                            replica=name,
                            version=version,
                        ),
                    )

    def _set_manifest(
        self,
        st: ModelState,
        version: int,
        replica: str,
        layout: int,
        shard_idx: int,
        manifest: ShardManifest,
    ) -> None:
        # exact per-replica entry first (alias-free; readers resolve their
        # assigned source here)
        rep_map = st.replica_manifests.setdefault(version, {})
        rprev = rep_map.get((replica, shard_idx))
        if rprev is None or (
            all(c == 0 for c in rprev.checksums) and any(manifest.checksums)
        ):
            rep_map[(replica, shard_idx)] = manifest
        # count-keyed family: first layout at this count wins; a same-count
        # manifest slicing along other axes is NOT an error (it lives in
        # the replica map), but a conflicting unit schema for the *same*
        # layout is.
        shard_map = st.manifests.setdefault(version, {})
        prev = shard_map.get((layout, shard_idx))
        if prev is not None:
            if prev.same_layout(manifest):
                if not prev.validate_against(manifest):
                    raise ShardLayoutError(
                        f"shard {shard_idx} of v{version}: manifest mismatch "
                        f"with the {layout}-shard layout family already "
                        "registered"
                    )
                # checksum upgrade: a resharding reader registers with zero
                # checksums (its buffers are pre-pull garbage) and re-puts
                # real ones once the pull completes, restoring end-to-end
                # verification for downstream same-layout readers
                if all(c == 0 for c in prev.checksums) and any(manifest.checksums):
                    shard_map[(layout, shard_idx)] = manifest
            return
        shard_map[(layout, shard_idx)] = manifest

    # -- scheduling (4.3.1) -----------------------------------------------------

    def _is_quarantined(self, info: Optional[ReplicaInfo]) -> bool:
        return info is not None and info.quarantined_until is not None

    def _source_candidates(
        self,
        st: ModelState,
        version: int,
        dest: ReplicaInfo,
        *,
        include_quarantined: bool = False,
    ) -> List[ReplicaVersionState]:
        vmap = st.versions.get(version, {})
        out = []
        for rv in vmap.values():
            if rv.replica == dest.name:
                continue
            if not rv.is_source_candidate():
                continue
            if rv.status == IN_PROGRESS and not self._pipeline:
                continue
            info = st.replicas.get(rv.replica)
            if info is None or info.failed:
                continue
            if not include_quarantined and self._is_quarantined(info):
                continue
            if rv.status == IN_PROGRESS and self._chain_reaches(
                vmap, rv.replica, dest.name
            ):
                # an in-progress candidate whose own source chain passes
                # through the destination would close a read cycle: each
                # end serves only its completed prefix and both tails gate
                # on the other forever. Reachable since re-partitioning
                # re-plans several readers at the same instant (a shared
                # swarm source dying); never valid, so never a candidate.
                continue
            out.append(rv)
        return out

    def _find_source(
        self, st: ModelState, version: int, dest: ReplicaInfo
    ) -> Optional[ReplicaVersionState]:
        cands = self._source_candidates(st, version, dest)
        if not cands:
            # every live candidate is quarantined: a suspect source still
            # beats no source — without the fallback a transient-only
            # fault schedule could starve readers of their only replica
            cands = self._source_candidates(
                st, version, dest, include_quarantined=True
            )
        if not cands:
            return None
        local = [c for c in cands if st.replicas[c.replica].datacenter == dest.datacenter]
        pool = local or cands

        def layout_penalty(c: ReplicaVersionState) -> int:
            # prefer same-layout sources: plain unit pulls beat the
            # reshard path (no repack) when both are available
            return 0 if st.replicas[c.replica].num_shards == dest.num_shards else 1

        if self._scheduler == "depth_aware":
            # prefer shallow sources, then least-loaded: builds a balanced
            # replication tree instead of a chain (EXPERIMENTS.md Perf)
            return min(pool, key=lambda c: (layout_penalty(c), c.refcount, c.depth, c.replica))
        if self._scheduler == "pinned":
            # naive-broadcast baseline: every reader hits the same (first
            # by name) source regardless of load — the behavior the
            # fan-out benchmark quantifies multi-source gains against
            return min(pool, key=lambda c: (layout_penalty(c), c.replica))
        # paper 4.3.1: least-loaded, deterministic tie-break
        return min(pool, key=lambda c: (layout_penalty(c), c.refcount, c.replica))

    def _only_seeding_sources(
        self, st: ModelState, version: int, dest: ReplicaInfo
    ) -> bool:
        cands = self._source_candidates(st, version, dest)
        local = [c for c in cands if st.replicas[c.replica].datacenter == dest.datacenter]
        if not local:
            return False
        return all(c.seeding and c.status == IN_PROGRESS for c in local)

    def _cross_dc(self, st: ModelState, src: ReplicaVersionState, dest: ReplicaInfo) -> bool:
        return st.replicas[src.replica].datacenter != dest.datacenter

    def _source_payload_quantizable(
        self, st: ModelState, version: int, source_name: str, source_shards: int
    ) -> bool:
        """Whether negotiating a lossy reshard codec against this source
        can shrink any bytes: at least one transfer unit of its manifest
        carries a quantizable dtype. Falls back from the per-replica
        manifest to the shard-family manifest; an unseen manifest is
        treated as quantizable (optimistic — the worst case is
        passthrough framing, never corruption)."""
        from repro_torch.transfer.codec import manifest_quantizable

        m = st.replica_manifests.get(version, {}).get((source_name, 0))
        if m is None:
            m = st.manifests.get(version, {}).get((source_shards, 0))
        if m is None:
            return True
        return manifest_quantizable(m)

    def _make_assignment(
        self,
        st: ModelState,
        version: int,
        src: ReplicaVersionState,
        *,
        dest: ReplicaInfo,
        plan: Optional[List[Tuple[str, int, int]]] = None,
        epoch: int = 0,
        record_stats: bool = False,
    ) -> Assignment:
        cross = self._cross_dc(st, src, dest)
        vmap = st.versions.get(version, {})
        # stats are only recorded on the LOGGED path (_assign): the
        # unlogged rebuild paths (get_assignment, redeem) re-derive the
        # same plan, and server.stats sits inside the failover state
        # digest — bumping it off-log would break replay equality.
        tally = {"degrade": False, "delta": False}

        def codec_for(is_cross: bool, source_shards: int, source_name: str) -> str:
            from repro_torch.transfer.codec import get_codec, reshard_wire_codec

            # per-link negotiation: WAN-crossing slices carry the WAN
            # codec; intra-DC stays raw.
            if not is_cross:
                return "raw"
            resharded = source_shards != dest.num_shards
            aliased = False
            if not resharded:
                # aliased layout: same shard count but a different unit
                # slicing also runs the resharded interval-read path
                sm = st.replica_manifests.get(version, {}).get((source_name, 0))
                fam = st.manifests.get(version, {}).get((dest.num_shards, 0))
                aliased = (
                    sm is not None and fam is not None and not sm.same_layout(fam)
                )
            if resharded or aliased:
                # cross-layout pulls run the row-grid interval-read path:
                # the WAN codec rides the widened unit-range reads, with
                # delta collapsed to its base codec (residuals need the
                # destination's held bytes in the destination's layout,
                # which a cross-layout source does not have)
                codec = reshard_wire_codec(self._wan_codec)
                if not get_codec(codec).lossless and not (
                    self._source_payload_quantizable(
                        st, version, source_name, source_shards
                    )
                ):
                    # genuinely unalignable plan: every unit of the source
                    # payload would frame as passthrough (no quantizable
                    # dtype anywhere) — degrade to raw at PLAN time and
                    # tick the counter, not mid-flight
                    tally["degrade"] = True
                    return "raw"
                return codec
            codec = self._wan_codec
            # delta negotiation: both endpoints retired the same prior
            # version, so the source can ship int8 residuals against the
            # base the destination still holds. Any endpoint that cannot
            # (fresh destination, GC'd base, re-plan/steal/failover
            # reassert onto a snapshot-less source) negotiates — or falls
            # back on the wire to — the plain base codec.
            s_info = st.replicas.get(source_name)
            if (
                self._wan_delta
                and codec in ("raw", "int8")
                and dest.prior_version is not None
                and dest.prior_version < version
                and s_info is not None
                and s_info.prior_version == dest.prior_version
            ):
                tally["delta"] = True
                return f"delta:{codec}"
            return codec

        slices = []
        for name, a, b in plan or []:
            s_rv = vmap.get(name)
            if s_rv is None:
                continue
            s_cross = self._cross_dc(st, s_rv, dest)
            s_shards = st.replicas[name].num_shards
            slices.append(
                SourceSlice(
                    source=name,
                    source_kind=s_rv.kind,
                    transport="tcp" if s_cross else "rdma",
                    start_unit=a,
                    stop_unit=b,
                    seeding=s_cross,
                    source_shards=s_shards,
                    ceiling=self._source_ceiling(st, s_rv),
                    codec=codec_for(s_cross, s_shards, name),
                )
            )
        src_shards = st.replicas[src.replica].num_shards
        assignment = Assignment(
            version=version,
            source=src.replica,
            source_kind=src.kind,
            transport="tcp" if cross else "rdma",
            seeding=cross,
            source_shards=src_shards,
            dest_shards=dest.num_shards,
            sources=tuple(slices),
            epoch=epoch,
            codec=slices[0].codec
            if slices
            else codec_for(cross, src_shards, src.replica),
        )
        if record_stats:
            if tally["degrade"]:
                self.stats["codec_degrades"] += 1
            if tally["delta"]:
                self.stats["delta_assignments"] += 1
        return assignment

    # -- multi-source planning (windowed data plane) ----------------------------

    def _acquire_source(
        self, st: ModelState, src: ReplicaVersionState, dest: ReplicaInfo
    ) -> None:
        src.refcount += 1
        info = st.replicas.get(src.replica)
        n = info.num_shards if info is not None else dest.num_shards
        for s in range(n):
            src.shard_readers[s] = src.shard_readers.get(s, 0) + 1

    def _release_sources(
        self, vmap: Dict[str, ReplicaVersionState], rv: ReplicaVersionState
    ) -> None:
        """Drop every source reference a reader holds (its whole plan)."""
        names = {s for s, _, _ in rv.plan}
        if rv.source is not None:
            names.add(rv.source)
        for name in names:
            src = vmap.get(name)
            if src is None:
                continue
            if src.refcount > 0:
                src.refcount -= 1
            for k in src.shard_readers:
                if src.shard_readers[k] > 0:
                    src.shard_readers[k] -= 1
        rv.plan = []
        rv.source = None

    def _dest_num_units(
        self, st: ModelState, version: int, dest: ReplicaInfo
    ) -> Optional[int]:
        m = st.manifests.get(version, {}).get((dest.num_shards, 0))
        return None if m is None else m.num_units

    def _pref_key(self, st: ModelState, rv: ReplicaVersionState, dest: ReplicaInfo):
        """Topology preference: same-node > same-DC > cross-DC, then
        least-loaded, with deterministic tie-breaks."""
        info = st.replicas[rv.replica]
        dest_nodes = {w.node for w in dest.workers.values()}
        if dest_nodes & {w.node for w in info.workers.values()}:
            topo = 0
        elif info.datacenter == dest.datacenter:
            topo = 1
        else:
            topo = 2
        return (topo, rv.refcount, rv.depth, rv.replica)

    def _multi_pool(
        self, st: ModelState, version: int, dest: ReplicaInfo
    ) -> List[ReplicaVersionState]:
        """Replicas a multi-source plan may partition units across: fully
        published same-shard-count GPU replicas in the destination's
        datacenter whose manifests are byte-identical slicings (unit pulls
        are only interchangeable between identical layouts). Fewer than
        two means no multi-source plan (callers fall back to the legacy
        single-source scheduler, which also handles cross-DC seeding,
        offload copies and pipeline chaining off in-progress replicas)."""
        n_units = self._dest_num_units(st, version, dest)
        if n_units is None:
            return []
        out = []
        for rv in st.versions.get(version, {}).values():
            if rv.replica == dest.name or rv.status != PUBLISHED:
                continue
            if rv.kind != KIND_GPU:
                continue
            info = st.replicas.get(rv.replica)
            if info is None or info.failed or self._is_quarantined(info):
                continue
            if info.num_shards != dest.num_shards:
                continue
            if info.datacenter != dest.datacenter:
                continue
            # fully held: every shard's progress covers every unit
            if len(rv.progress) < info.num_shards or (
                rv.progress and min(rv.progress.values()) < n_units
            ):
                continue
            out.append(rv)
        if len(out) < 2:
            return out
        out.sort(key=lambda rv: self._pref_key(st, rv, dest))
        # layout-identity filter against the destination's own manifest
        # when it registered one (reshard readers do), else the shard-count
        # family. Same-count replicas sliced along other axes must not be
        # mixed into a unit-partitioned plan.
        ref = st.replica_manifests.get(version, {}).get(
            (dest.name, 0)
        ) or st.manifests.get(version, {}).get((dest.num_shards, 0))
        if ref is None:
            return out[:1]
        kept = []
        for rv in out:
            m = self._replica_manifest(st, version, rv.replica, 0)
            if m is not None and m.same_layout(ref):
                kept.append(rv)
        return kept

    # -- swarm replication: unit-granular availability map + planner ------------

    def _source_ceiling(self, st: ModelState, rv: ReplicaVersionState) -> int:
        """Progress ceiling of one source: ``-1`` (unbounded) for a fully
        published replica, else the min-over-shards completed prefix."""
        info = st.replicas.get(rv.replica)
        n_shards = info.num_shards if info is not None else len(rv.progress)
        if (
            rv.status == PUBLISHED
            and info is not None
            and len(rv.progress) >= info.num_shards
        ):
            return -1
        if not rv.progress or len(rv.progress) < n_shards:
            return 0  # a shard with no counter yet has served nothing
        return min(rv.progress.values())

    def _chain_reaches(
        self, vmap: Dict[str, ReplicaVersionState], name: str, target: str
    ) -> bool:
        """True when ``name``'s transitive source chain includes ``target``
        — admitting it as a swarm source for ``target`` would close a
        read cycle whose tails gate on each other forever."""
        seen: Set[str] = set()
        stack = [name]
        while stack:
            n = stack.pop()
            if n == target:
                return True
            if n in seen:
                continue
            seen.add(n)
            rv = vmap.get(n)
            if rv is None or rv.status != IN_PROGRESS:
                continue
            for s, _, _ in rv.plan:
                stack.append(s)
            if rv.source is not None:
                stack.append(rv.source)
        return False

    def availability(self, model: str, version: int) -> Dict[str, int]:
        """The unit-granular availability map (swarm replication): for
        every live replica holding ``version``, how many transfer units
        of its prefix are servable right now (``min`` over shards;
        published replicas report their full unit count). Diagnostic /
        test surface for the swarm planner's inputs."""
        self._check_alive()
        st = self._model(model)
        out: Dict[str, int] = {}
        for rv in st.versions.get(version, {}).values():
            info = st.replicas.get(rv.replica)
            if info is None or info.failed:
                continue
            if rv.status not in (PUBLISHED, IN_PROGRESS):
                continue
            m = self._replica_manifest(st, version, rv.replica, 0)
            full = m.num_units if m is not None else 0
            c = self._source_ceiling(st, rv)
            out[rv.replica] = full if c < 0 else min(c, full) if full else c
        return out

    # -- metrics (observability surface for the future networked server) -------

    def metrics(self) -> Dict[str, Dict[str, float]]:
        """Point-in-time metrics snapshot, split by replay contract:

        ``counters`` and ``state`` are derived purely from op-log-covered
        state (``stats`` + model/replica state), so two digest-equal
        servers — e.g. the original and its crash-recovered twin — report
        identical values. ``gauges`` carry wall-clock and log-transport
        values (failover recovery duration, op-log batching) that are
        intentionally exempt from that equality.

        Deliberately NOT guarded by the liveness check: scraping a
        crashed controller's last-known metrics is exactly how its death
        gets diagnosed."""
        counters: Dict[str, float] = {k: float(v) for k, v in self.stats.items()}
        state: Dict[str, float] = {
            "models": float(len(self._models)),
            "replicas_in_progress": 0.0,
            "replicas_published": 0.0,
            "replicas_draining": 0.0,
            "replicas_registered": 0.0,
            "replicas_failed": 0.0,
            "availability_units": 0.0,
            "plan_epochs": 0.0,
            "pending_replicates": 0.0,
        }
        by_status = {
            IN_PROGRESS: "replicas_in_progress",
            PUBLISHED: "replicas_published",
            DRAINING: "replicas_draining",
        }
        for st in self._models.values():
            state["pending_replicates"] += len(st.pending)
            for info in st.replicas.values():
                if info.failed:
                    state["replicas_failed"] += 1
                elif info.registered:
                    state["replicas_registered"] += 1
            for version, vmap in st.versions.items():
                for rv in vmap.values():
                    key = by_status.get(rv.status)
                    if key is not None:  # per-version replica states
                        state[key] += 1
                    state["plan_epochs"] += rv.assign_epoch
                    # availability depth of the latest version: how many
                    # servable units the swarm planner can draw on
                    if version == st.latest:
                        info = st.replicas.get(rv.replica)
                        if info is None or info.failed:
                            continue
                        if rv.status not in (PUBLISHED, IN_PROGRESS):
                            continue
                        m = self._replica_manifest(st, version, rv.replica, 0)
                        full = m.num_units if m is not None else 0
                        c = self._source_ceiling(st, rv)
                        state["availability_units"] += (
                            full if c < 0 else min(c, full) if full else c
                        )
        gauges: Dict[str, float] = {
            "failover_last_recovery_seconds": float(self.last_recovery_s),
        }
        log = self._log
        if log is not None:
            records = sum(1 for _ in log.committed())
            flushes = log.flushes
            gauges["oplog_committed_records"] = float(records)
            gauges["oplog_flushes"] = float(flushes)
            gauges["oplog_group_commit"] = float(log.group_commit)
            # avg records per durable flush: direct (in-memory) mode
            # commits record-at-a-time without flushing
            gauges["oplog_avg_batch"] = (
                records / flushes if flushes else (1.0 if records else 0.0)
            )
        return {"counters": counters, "state": state, "gauges": gauges}

    def metrics_text(self) -> str:
        """Prometheus-style text exposition of :meth:`metrics` (the scrape
        format the future networked server will serve on /metrics)."""
        m = self.metrics()
        lines: List[str] = []
        for section, ptype in (
            ("counters", "counter"),
            ("state", "gauge"),
            ("gauges", "gauge"),
        ):
            for name in sorted(m[section]):
                val = m[section][name]
                full = f"tensorhub_{name}"
                lines.append(f"# TYPE {full} {ptype}")
                text = f"{val:.6f}".rstrip("0").rstrip(".") if val % 1 else str(int(val))
                lines.append(f"{full} {text}")
        return "\n".join(lines) + "\n"

    def _swarm_pool(
        self, st: ModelState, version: int, dest: ReplicaInfo, start: int
    ) -> List[Tuple[ReplicaVersionState, int]]:
        """Sources a swarm plan may tile a destination's units across:
        same-DC, same-shard-count, layout-identical GPU replicas that are
        either fully published or in progress with a non-empty completed
        prefix beyond ``start``. Returns (state, ceiling) pairs in
        preference order — topology first, then load, then the deeper
        prefix — where ``ceiling`` is the unit count the source can serve
        today (``num_units`` for published replicas).

        Keeping the pool same-DC is what makes the WAN invariant hold: a
        same-DC *in-progress* peer always outranks a cross-DC published
        source (the latter is never admitted), so one seeding replica's
        prefix feeds its whole datacenter and the cross-DC link carries
        exactly one copy."""
        n_units = self._dest_num_units(st, version, dest)
        if n_units is None or not self._pipeline:
            return []
        vmap = st.versions.get(version, {})
        out: List[Tuple[ReplicaVersionState, int]] = []
        for rv in vmap.values():
            if rv.replica == dest.name or rv.kind != KIND_GPU:
                continue
            if rv.status not in (PUBLISHED, IN_PROGRESS):
                continue
            info = st.replicas.get(rv.replica)
            if info is None or info.failed or self._is_quarantined(info):
                continue
            if info.num_shards != dest.num_shards:
                continue
            if info.datacenter != dest.datacenter:
                continue
            c = self._source_ceiling(st, rv)
            ceiling = n_units if c < 0 else min(c, n_units)
            if ceiling <= start:
                continue  # nothing we still need; rejoins on announce/steal
            if rv.status == IN_PROGRESS and self._chain_reaches(
                vmap, rv.replica, dest.name
            ):
                continue
            out.append((rv, ceiling))
        if not out:
            return out

        def key(e: Tuple[ReplicaVersionState, int]):
            rv, ceiling = e
            topo, refcount, depth, name = self._pref_key(st, rv, dest)
            # availability breaks load ties: the deeper prefix first. For
            # an all-published pool every ceiling equals n_units and the
            # order collapses to the pre-swarm (topo, load, depth, name).
            return (topo, refcount, -ceiling, depth, name)

        out.sort(key=key)
        # layout-identity filter, exactly as in _multi_pool: unit pulls
        # are interchangeable only between byte-identical slicings
        ref = st.replica_manifests.get(version, {}).get(
            (dest.name, 0)
        ) or st.manifests.get(version, {}).get((dest.num_shards, 0))
        if ref is None:
            return out[:1]
        kept = []
        for rv, ceiling in out:
            m = self._replica_manifest(st, version, rv.replica, 0)
            if m is not None and m.same_layout(ref):
                kept.append((rv, ceiling))
        return kept

    def _swarm_supply(
        self,
        chosen: List[Tuple[ReplicaVersionState, int]],
        start: int,
        num_units: int,
    ) -> float:
        """Aggregate serving capacity of a candidate plan, in units of one
        dedicated uplink: each member contributes its load share
        (``1/(1+refcount)``) scaled by how much of the *remaining* range
        its prefix can actually serve. This is the chain-vs-swarm decision
        input: a dedicated in-progress relay moves bytes link-disjointly
        at one full uplink, so fanning out only wins when the pool offers
        at least that much — otherwise (single contended seed, lockstep
        prefixes) the swarm would starve itself and a staggered pipeline
        chain is strictly better."""
        span = max(1, num_units - start)
        supply = 0.0
        for rv, ceiling in chosen:
            if ceiling >= num_units:
                frac = 1.0
            else:
                frac = max(0.0, min(1.0, (ceiling - start) / span))
            supply += frac / (1.0 + rv.refcount)
        return supply

    def _swarm_wins(
        self,
        st: ModelState,
        version: int,
        dest: ReplicaInfo,
        pool: List[Tuple[ReplicaVersionState, int]],
        src: Optional[ReplicaVersionState],
        start: int,
        num_units: int,
    ) -> bool:
        """Whether to install a swarm plan instead of the legacy scheduler's
        choice: always when there is no dedicated relay to protect (the
        best single source is published or gone) or units are giant
        (store-and-forward granularity kills chains); else only when the
        pool's aggregate supply matches a dedicated uplink."""
        if src is None or src.status == PUBLISHED:
            return True
        if self._has_giant_units(st, version, dest):
            return True
        chosen = self._swarm_chosen(pool)
        return self._swarm_supply(chosen, start, num_units) >= 1.0

    def _swarm_chosen(
        self, pool: List[Tuple[ReplicaVersionState, int]]
    ) -> List[Tuple[ReplicaVersionState, int]]:
        """The plan members: the ``max_sources`` most-preferred sources,
        with the deepest-prefix source guaranteed a slot (it serves the
        tail — without it a plan of shallow prefixes could not tile the
        whole shard)."""
        chosen = list(pool[: self._max_sources])
        best = max(range(len(pool)), key=lambda i: (pool[i][1], -i))
        if all(pool[best][0] is not rv for rv, _ in chosen):
            chosen[-1] = pool[best]
        return chosen

    def _swarm_partition(
        self,
        pool: List[Tuple[ReplicaVersionState, int]],
        start: int,
        num_units: int,
    ) -> List[Tuple[str, int, int]]:
        """Ceiling-aware tiling of units ``[start, num_units)``.

        When every chosen source is fully available this degrades to the
        pre-swarm ``_partition_units`` (bit-for-bit — the ``swarm=False``
        parity anchor). Otherwise: partial prefixes serve the head of the
        range (their ceilings are prefixes, so low units are what they
        hold), sized by inverse load and *clipped to their ceilings*; the
        deepest-prefix source serves the tail. The tail slice is the only
        one allowed to extend past its source's ceiling, and only when no
        fully-published source is in the pool — those reads gate on the
        source's live progress counter (pipeline chaining), exactly like
        a PR 2 relay."""
        chosen = self._swarm_chosen(pool)
        if all(c >= num_units for _, c in chosen):
            return self._partition_units([rv for rv, _ in chosen], start, num_units)
        tail_i = max(range(len(chosen)), key=lambda i: (chosen[i][1], -i))
        tail_rv = chosen[tail_i][0]
        heads = sorted(
            (e for i, e in enumerate(chosen) if i != tail_i),
            key=lambda e: (e[1], e[0].replica),  # shallow prefixes first
        )
        remaining = num_units - start
        weights = {rv.replica: 1.0 / (1.0 + rv.refcount) for rv, _ in chosen}
        total = sum(weights.values())
        plan: List[Tuple[str, int, int]] = []
        pos = start
        for rv, ceiling in heads:
            share = max(1, int(remaining * weights[rv.replica] / total))
            n = max(0, min(share, ceiling - pos, num_units - pos))
            plan.append((rv.replica, pos, pos + n))
            pos += n
        plan.append((tail_rv.replica, pos, num_units))
        return plan

    def _partition_units(
        self,
        pool: List[ReplicaVersionState],
        start: int,
        num_units: int,
    ) -> List[Tuple[str, int, int]]:
        """Partition units ``[start, num_units)`` into contiguous ranges
        across the pool (preference order), sized inversely to each
        source's current reader load. The most-preferred source serves the
        head of the range — the units gating downstream pipeline chains.
        With fewer units than sources, the extra sources get empty ranges:
        they still join the plan so the data plane can spread the chunks
        of a giant unit across their uplinks."""
        remaining = num_units - start
        srcs = pool[: self._max_sources]
        if remaining < len(srcs):
            plan = []
            pos = start
            for i, rv in enumerate(srcs):
                n = 1 if i < remaining else 0
                plan.append((rv.replica, pos, pos + n))
                pos += n
            return plan
        weights = [1.0 / (1.0 + rv.refcount) for rv in srcs]
        total = sum(weights)
        shares = [max(1, int(remaining * w / total)) for w in weights]
        while sum(shares) > remaining:
            i = max(range(len(shares)), key=lambda j: (shares[j], j))
            shares[i] -= 1
        i = 0
        while sum(shares) < remaining:
            shares[i % len(shares)] += 1
            i += 1
        plan: List[Tuple[str, int, int]] = []
        pos = start
        for rv, n in zip(srcs, shares):
            plan.append((rv.replica, pos, pos + n))
            pos += n
        return plan

    def _has_giant_units(
        self, st: ModelState, version: int, dest: ReplicaInfo
    ) -> bool:
        """True when the destination's units exceed the chunk threshold —
        such workloads replicate badly over store-and-forward pipeline
        chains (a relay serves only completed units), so the scheduler
        prefers chunk-spreading them across fully-published replicas."""
        m = st.manifests.get(version, {}).get((dest.num_shards, 0))
        if m is None or not m.units:
            return False
        return max(u.nbytes for u in m.units) > self._chunk_hint

    def _plan_assignment(
        self, st: ModelState, dest: ReplicaInfo, version: int, *, start: int = 0
    ) -> Optional[List[Tuple[str, int, int]]]:
        """Multi-source plan when >=2 eligible published replicas exist
        (and the feature is on); else a single-slice plan from the legacy
        scheduler. None when no live source exists at all.

        An idle in-progress replica (the least-loaded candidate) beats a
        multi-source plan for fine-grained workloads: a dedicated pipeline
        relay moves bytes link-disjointly at full rate, while fanning the
        tail onto already-shared publisher uplinks would contend. Chains
        lose only when units are giant (store-and-forward granularity) —
        then the published pool with sub-unit chunking wins.

        Swarm replication generalizes both: in-progress replicas join the
        pool for the prefix they have completed, so every plan is a blend
        of published partitioning and pipeline chaining — the dedicated
        relay is just the degenerate one-member swarm."""
        src = self._find_source(st, version, dest)
        num_units = self._dest_num_units(st, version, dest)
        if num_units is not None:
            # a progress report past the unit count (client bug, adversarial
            # test) must not produce an inverted range
            start = min(start, num_units)
        if self._max_sources > 1:
            if num_units is not None and num_units - start >= 1:
                if self._swarm:
                    spool = self._swarm_pool(st, version, dest, start)
                    if len(spool) >= 2 and self._swarm_wins(
                        st, version, dest, spool, src, start, num_units
                    ):
                        return self._swarm_partition(spool, start, num_units)
                pool = self._multi_pool(st, version, dest)
                if len(pool) >= 2 and (
                    src is None
                    or src.status == PUBLISHED
                    or self._has_giant_units(st, version, dest)
                ):
                    return self._partition_units(pool, start, num_units)
        if src is None:
            return None
        return [(src.replica, start, -1 if num_units is None else num_units)]

    def _install_plan(
        self,
        st: ModelState,
        version: int,
        rv: ReplicaVersionState,
        dest_info: ReplicaInfo,
        plan: List[Tuple[str, int, int]],
    ) -> None:
        """Swap an in-progress reader onto a new plan (re-route/steal)."""
        vmap = st.versions[version]
        self._release_sources(vmap, rv)
        for name, _, _ in plan:
            self._acquire_source(st, vmap[name], dest_info)
        rv.plan = list(plan)
        rv.source = plan[0][0]
        rv.seeding = self._cross_dc(st, vmap[plan[0][0]], dest_info)
        rv.assign_epoch += 1
        rv.plan_gen = st.source_gen.get(version, 0)

    def _steal_work(
        self, st: ModelState, version: int, rv: ReplicaVersionState
    ) -> None:
        """Re-partition an in-progress reader's remaining units when the
        candidate pool gained a source its plan does not use."""
        if self._max_sources <= 1:
            return  # single-source mode: no mid-transfer re-partitioning
        info = st.replicas.get(rv.replica)
        if info is None or info.failed:
            return
        rv.plan_gen = st.source_gen.get(version, 0)  # scanned at this gen
        num_units = self._dest_num_units(st, version, info)
        if num_units is None:
            return
        start = min(rv.progress.values()) if rv.progress else 0
        if num_units - start < 2:
            return
        if self._swarm and self._pipeline:
            # Swarm growth: the availability map changed (a peer announced
            # its prefix, a replica published or completed). Re-partition
            # the *unserved tail* only when (a) the grown pool actually
            # out-supplies the current primary — a healthy dedicated chain
            # is never broken for a starving swarm — and (b) the plan
            # would gain a member; same-membership re-tilings are skipped
            # because the data plane's availability-aware claiming already
            # rebalances load inside the current membership without an
            # epoch bump. The bump reuses the PR 2 resume-from-prefix
            # machinery: the tail re-tiles, completed units are never
            # re-read.
            if num_units - start < 2 * self._max_sources:
                # an epoch bump drains the in-flight window and refills it
                # (a pipeline bubble of ~max_sources claims); a short tail
                # cannot amortize that, so the end-game keeps its plan
                return
            vmap = st.versions.get(version, {})
            primary = vmap.get(rv.source) if rv.source else None
            if (
                primary is not None
                and primary.status == IN_PROGRESS
                and not self._has_giant_units(st, version, info)
            ):
                # the primary is a live pipeline relay: its staggered
                # prefix moves bytes link-disjointly at full rate, and the
                # epidemic already flows through it — growing this plan
                # would trade a dedicated uplink for shares of contended
                # ones (chains break only on death or giant units)
                return
            spool = self._swarm_pool(st, version, info, start)
            if len(spool) >= 2 and self._swarm_wins(
                st, version, info, spool, primary, start, num_units
            ):
                plan = self._swarm_partition(spool, start, num_units)
                current = {s for s, _, _ in rv.plan}
                if not {s for s, _, _ in plan} <= current:
                    self._install_plan(st, version, rv, info, plan)
                    self.stats["swarm_grows"] += 1
                    self.stats["work_steals"] += 1
            return
        # Steal only where a re-partition can actually win: giant-unit
        # workloads (chunk spread rebalances as full copies appear), or a
        # single-source plan on a *contended* published source. Healthy
        # fine-grained pipeline chains and dedicated sources are left
        # alone — a dedicated relay moves bytes link-disjointly at full
        # rate, and re-planning it would only add churn.
        vmap = st.versions.get(version, {})
        primary = vmap.get(rv.source) if rv.source else None
        if not self._has_giant_units(st, version, info):
            if len(rv.plan) > 1:
                return
            if primary is not None and (
                primary.status == IN_PROGRESS or primary.refcount <= 1
            ):
                return
        pool = self._multi_pool(st, version, info)
        if len(pool) < 2:
            return
        current = {s for s, _, _ in rv.plan}
        if {p.replica for p in pool[: self._max_sources]} <= current:
            return
        plan = self._partition_units(pool, start, num_units)
        self._install_plan(st, version, rv, info, plan)
        self.stats["work_steals"] += 1

    def _assign(self, st: ModelState, dest: ReplicaInfo, version: int) -> Assignment:
        plan = self._plan_assignment(st, dest, version)
        if plan is None:
            raise VersionUnavailableError(
                f"model {st.name} v{version}: no live replica to serve the read"
            )
        vmap = st.versions[version]
        for name, _, _ in plan:
            self._acquire_source(st, vmap[name], dest)
        primary = vmap[plan[0][0]]
        assignment = self._make_assignment(
            st, version, primary, dest=dest, plan=plan, record_stats=True
        )
        self._install_replica_version(
            st,
            dest,
            version,
            status=IN_PROGRESS,
            kind=dest.kind,
            source=primary.replica,
            seeding=assignment.seeding,
        )
        rv = st.versions[version][dest.name]
        rv.plan = list(plan)
        rv.plan_gen = st.source_gen.get(version, 0)
        rv.depth = primary.depth + 1
        for s in range(dest.num_shards):
            rv.progress[s] = 0
        self.stats["replications_started"] += 1
        if len(plan) > 1:
            self.stats["multi_source_assignments"] += 1
        if any(s.ceiling >= 0 for s in assignment.sources):
            self.stats["swarm_assignments"] += 1  # a partial prefix serves
        return assignment

    def _ensure_offload_seed(
        self, st: ModelState, version: int, dest: ReplicaInfo
    ) -> bool:
        """At most one offload-seeding replica per datacenter (4.3.4).
        Returns True if this call created it (the caller's client library
        owns the background fetch)."""
        for rv in st.versions.get(version, {}).values():
            info = st.replicas.get(rv.replica)
            if (
                info is not None
                and rv.kind == KIND_OFFLOAD
                and info.datacenter == dest.datacenter
            ):
                return False  # someone already seeds this DC
        # The *caller* becomes the seeder: we install an in-progress offload
        # replica entry sourced cross-DC.
        off = offload_name(dest.name)
        offinfo = st.replicas.get(off)
        if offinfo is None:
            offinfo = ReplicaInfo(
                name=off,
                num_shards=dest.num_shards,
                datacenter=dest.datacenter,
                is_spot=dest.is_spot,
                kind=KIND_OFFLOAD,
                workers=dict(dest.workers),
                open_shards=set(dest.open_shards),
            )
            st.replicas[off] = offinfo
        src = self._find_source(st, version, offinfo)
        if src is None:
            return False
        self._acquire_source(st, src, offinfo)
        self._install_replica_version(
            st,
            offinfo,
            version,
            status=IN_PROGRESS,
            kind=KIND_OFFLOAD,
            source=src.replica,
            seeding=True,
        )
        rv = st.versions[version][off]
        rv.seed_cache = True
        rv.plan = [(src.replica, 0, -1)]
        rv.plan_gen = st.source_gen.get(version, 0)
        for s in range(offinfo.num_shards):
            rv.progress[s] = 0
        self.stats["replications_started"] += 1
        return True

    def _service_pending(self, st: ModelState) -> None:
        """Try to assign parked replicate() groups after every publish or
        completion."""
        still: List[_PendingReplicate] = []
        for p in st.pending:
            info = st.replicas.get(p.replica)
            if info is None or info.failed:
                continue  # group died while parked
            v = version_lib.resolve(p.spec, st.latest)
            if v is None or self._find_source(st, v, info) is None:
                still.append(p)
                continue
            p.assignment = self._assign(st, info, v)
            # deliver through txn cache so every shard sees it
            key = (p.replica, p.op_id)
            txn = st.txns.get(key)
            if txn is not None:
                txn.result = p.assignment
        st.pending = still

    # -- failure handling --------------------------------------------------------

    def _fail_replica(self, st: ModelState, replica: str, *, reason: str) -> None:
        self.stats["evictions"] += 1
        self._remove_replica(st, replica, reason=reason)
        # the offload twin lives in the same process: dies together
        off = offload_name(replica)
        if off in st.replicas and not st.replicas[off].failed:
            self._remove_replica(st, off, reason=reason)
        # Proactive blast-radius control: a swarm source sits in *many*
        # readers' plans, so waiting for each reader to observe its dead
        # flows (RDMA timeout) multiplies the detection latency across the
        # swarm. Re-partition every affected reader's unserved tail now;
        # the epoch bump reaches their data planes on the next claim.
        dead = {replica, off}
        for version in list(st.versions.keys()):
            vmap = st.versions.get(version, {})
            for rv in list(vmap.values()):
                if rv.status != IN_PROGRESS:
                    continue
                names = {s for s, _, _ in rv.plan}
                if rv.source is not None:
                    names.add(rv.source)
                if not names & dead:
                    continue
                info = st.replicas.get(rv.replica)
                if info is None or info.failed:
                    continue
                start = min(rv.progress.values()) if rv.progress else 0
                plan = self._plan_assignment(st, info, version, start=start)
                if plan is None:
                    continue  # no live source left; readers keep polling
                self._install_plan(st, version, rv, info, plan)
                self.stats["reassignments"] += 1

    def _remove_replica(self, st: ModelState, replica: str, *, reason: str) -> None:
        info = st.replicas.get(replica)
        if info is None:
            return
        info.failed = True
        for v in list(st.versions.keys()):
            self._drop_replica_version(st, replica, v)
        st.pending = [p for p in st.pending if p.replica != replica]
        for key in [k for k in st.txns if k[0] == replica]:
            del st.txns[key]
        for key in [k for k in st.done_txns if k[0] == replica]:
            del st.done_txns[key]
        for w in info.workers.values():
            self._emit(
                w.worker_id,
                Event(kind="evicted", model=st.name, replica=replica, reason=reason),
            )
        # readers sourced from this replica will report transfer failure and
        # be re-routed by report_transfer_failure/_reassign.
        del st.replicas[replica]

    def _current_state(
        self, st: ModelState, replica: str
    ) -> Optional[ReplicaVersionState]:
        info = st.replicas.get(replica)
        if info is None or info.current_version is None:
            return None
        return st.versions.get(info.current_version, {}).get(replica)

    def _reassign(self, st: ModelState, dest_replica: str) -> None:
        info = st.replicas.get(dest_replica)
        if info is None or info.failed:
            return
        # find dest's in-progress state (gpu or offload twin)
        for name in (dest_replica, offload_name(dest_replica)):
            rinfo = st.replicas.get(name)
            if rinfo is None:
                continue
            for version, vmap in st.versions.items():
                rv = vmap.get(name)
                if rv is None or rv.status != IN_PROGRESS:
                    continue
                planned = {s for s, _, _ in rv.plan}
                if rv.source is not None:
                    planned.add(rv.source)
                healthy = all(
                    s in vmap and not self._is_quarantined(st.replicas.get(s))
                    for s in planned
                )
                if planned and healthy:
                    continue  # every plan source still alive; nothing to do
                # re-partition the uncompleted tail across the survivors
                start = min(rv.progress.values()) if rv.progress else 0
                plan = self._plan_assignment(st, rinfo, version, start=start)
                if plan is None:
                    continue  # graceful: reader keeps polling, may error out
                if list(plan) == list(rv.plan):
                    # quarantine fallback landed on the identical plan (the
                    # suspect is the only source): bumping the epoch would
                    # drain the reader's window for nothing
                    continue
                self._install_plan(st, version, rv, rinfo, plan)
                self.stats["reassignments"] += 1


def offload_name(replica: str) -> str:
    return f"{replica}@offload"


# wire registration (op-log payloads + failover snapshots); _Txn is
# handled by repro_torch.core.failover directly — its on_last callback cannot
# travel and is rebuilt from the op kind on restore
for _cls in (
    PublishResult,
    UnpublishResult,
    UpdateDecision,
    Event,
    ReplicaVersionState,
    ReplicaInfo,
    _PendingReplicate,
):
    meta_defaults.register_wire(_cls)
