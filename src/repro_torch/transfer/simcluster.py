"""Simulated TensorHub cluster: real control plane, fluid data plane.

The *same* :class:`repro_torch.core.server.ReferenceServer` used by the threaded
client is driven here by generator processes over the discrete-event
network (``simnet``). Weight bytes are represented by sizes only; progress
counters, transactions, retention, scheduling and failure handling are the
real production code paths.

This module is what the benchmark harness (one module per paper figure)
builds on, together with the calibrated baselines at the bottom (NCCL /
UCX / object-store models, 2.3 + 5).

The port's copy of the JAX package's ``transfer/simcluster.py``: the same
Python arithmetic over the port's control plane, so both packages report
the same virtual times, stalls and link bytes for the same scenario. It
touches no tensor. The one device constant, the drain rate of the fused
int8 decode of a resharded pull, is a third of the
:data:`~repro_torch.transfer.hardware.H100` profile's HBM rate, read when
the pull runs.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import warnings
import weakref
from typing import Callable, Dict, Generator, List, Optional, Sequence, Tuple

from repro_torch.core import failover as failover_lib
from repro_torch.core.errors import StaleHandleError, TensorHubError
from repro_torch.core.meta import (
    ShardManifest,
    TensorMeta,
    TransferUnit,
    WorkerInfo,
    dtype_itemsize,
)
from repro_torch.core.oplog import OpLog
from repro_torch.core.server import Assignment, ReferenceServer, SourceSlice, offload_name
from repro_torch.obs import telemetry as obs
from repro_torch.transfer import codec as codec_lib
from repro_torch.transfer.engine import DEFAULT_CHUNK_BYTES, DEFAULT_WINDOW
from repro_torch.transfer.faults import (
    DEFAULT_RETRY_POLICY,
    FaultPlan,
    RetryPolicy,
    SimFaultInjector,
)
from repro_torch.transfer.hardware import CLUSTER, H100, ClusterHW
from repro_torch.transfer.simnet import FlowKilled, Link, SimEnv, SimEvent, SimNetwork


class PreemptedError(Exception):
    """The worker itself was killed; its process stops executing (a real
    preempted worker sends nothing further — in particular it must NOT
    report its own source as failed)."""


class _SimSourceLost(Exception):
    """Internal: assigned source failed us mid-pull; re-route and resume.
    ``evidence`` mirrors the threaded client's classes ("fatal" |
    "transient" | "corrupt") and is forwarded to
    ``report_transfer_failure`` for strike-counting vs eviction."""

    def __init__(self, source: str, evidence: str = "fatal") -> None:
        super().__init__(source)
        self.source = source
        self.evidence = evidence


class _SimReplan(Exception):
    """Internal: the server re-partitioned our plan (work stealing or
    re-routing); re-fetch the assignment and resume from the prefix."""


#: one data-plane fetch: a whole transfer unit, or a byte sub-range of
#: one; ``owner`` is the index of the plan slice the server's partition
#: assigned it to (a load hint — any same-layout source may execute it)
_Task = collections.namedtuple("_Task", "unit offset nbytes owner")


class _SimSlots:
    """Counting semaphore over SimEvents: caps in-flight flows per shard."""

    def __init__(self, env: SimEnv, slots: int) -> None:
        self.env = env
        self.free = slots
        self._waiters: collections.deque = collections.deque()

    def acquire(self) -> SimEvent:
        ev = SimEvent(self.env)
        if self.free > 0:
            self.free -= 1
            ev.succeed()
        else:
            self._waiters.append(ev)
        return ev

    def release(self) -> None:
        if self._waiters:
            self._waiters.popleft().succeed()
        else:
            self.free += 1


def _sim_dtype(nbytes: int, dtype: str) -> Tuple[str, int]:
    """``(dtype, itemsize)`` for one size-only sim tensor: the requested
    element dtype when the byte count holds whole elements, else a uint8
    fallback (so odd sizes stay representable)."""
    if dtype != "uint8":
        isz = dtype_itemsize(dtype)
        if nbytes % isz == 0:
            return dtype, isz
    return "uint8", 1


def make_manifest(
    unit_bytes: Sequence[int], dtype: str = "uint8"
) -> ShardManifest:
    """Size-only manifest (the simulator moves no real bytes).

    ``dtype`` is the declared element type: the sim cluster passes its
    ``codec_dtype`` so server-side codec negotiation sees the same
    quantizable payload the fluid byte accounting assumes (a size-only
    uint8 stand-in would read as unquantizable and degrade to raw)."""
    tensors = []
    for i, n in enumerate(unit_bytes):
        n = int(n)
        dt, isz = _sim_dtype(n, dtype)
        tensors.append(
            TensorMeta(name=f"t{i}", shape=(n // isz,), dtype=dt, nbytes=n)
        )
    units = tuple(
        TransferUnit(index=i, name=f"t{i}", nbytes=int(n))
        for i, n in enumerate(unit_bytes)
    )
    return ShardManifest(
        tensors=tuple(tensors), units=units, checksums=(0,) * len(units)
    )


def make_layout_manifests(
    global_unit_bytes: Sequence[int], num_shards: int, dtype: str = "uint8"
) -> List[ShardManifest]:
    """Per-shard manifests with layout descriptors: each global transfer
    unit is a 1-D tensor sliced contiguously across ``num_shards``
    (the remainder rides on the last shard). Replicas built from the same
    ``global_unit_bytes`` with *different* shard counts are convertible —
    the resharding planner stripes reads across their shards.

    With a non-uint8 ``dtype`` the slicing happens in element space
    (shard boundaries stay element-aligned) so negotiation and the
    row-grid planner see a quantizable payload; a global size that does
    not hold whole elements falls back to uint8 for that tensor."""
    out: List[ShardManifest] = []
    for shard in range(num_shards):
        tensors: List[TensorMeta] = []
        units: List[TransferUnit] = []
        for k, g in enumerate(global_unit_bytes):
            g = int(g)
            dt, isz = _sim_dtype(g, dtype)
            ge = g // isz
            per = ge // num_shards
            start = shard * per
            stop = ge if shard == num_shards - 1 else start + per
            n = stop - start
            tensors.append(
                TensorMeta(
                    name=f"t{k}",
                    shape=(n,),
                    dtype=dt,
                    nbytes=n * isz,
                    global_shape=(ge,),
                    offset=(start,),
                )
            )
            units.append(TransferUnit(index=k, name=f"t{k}", nbytes=n * isz))
        out.append(
            ShardManifest(
                tensors=tuple(tensors),
                units=tuple(units),
                checksums=(0,) * len(units),
            )
        )
    return out


@dataclasses.dataclass
class SimWorker:
    """One shard-owning worker: a GPU with its NIC slice and PCIe lane."""

    worker_id: str
    node: str
    datacenter: str
    up: Link
    down: Link
    pcie: Link
    vpc_up: Link
    vpc_down: Link
    is_spot: bool = False
    alive: bool = True
    total_stall: float = 0.0
    _stall_since: Optional[float] = None
    #: stall decomposition: total_stall split into the canonical
    #: plan_wait / wire / decode / verify / control components
    #: (repro_torch.obs.telemetry.STALL_COMPONENTS). The shard attributes
    #: control-latency yields and flow time observed inside each stalled
    #: window; the residual is plan-wait. Components sum exactly to
    #: total_stall (decode/verify are instantaneous in the fluid model).
    stall_parts: Dict[str, float] = dataclasses.field(default_factory=dict)

    def stall_begin(self, now: float) -> None:
        if self._stall_since is None:
            self._stall_since = now

    def stall_end(self, now: float) -> None:
        if self._stall_since is not None:
            self.total_stall += now - self._stall_since
            self._stall_since = None

    def stall_attribute(
        self, total: float, ctrl: float, wire: float, decode: float = 0.0
    ) -> None:
        """Fold one stalled window's decomposition into ``stall_parts``."""
        parts = self.stall_parts
        parts["control"] = parts.get("control", 0.0) + ctrl
        parts["wire"] = parts.get("wire", 0.0) + wire
        if decode:
            parts["decode"] = parts.get("decode", 0.0) + decode
        parts["plan_wait"] = (
            parts.get("plan_wait", 0.0) + max(0.0, total - ctrl - wire - decode)
        )


class SimCluster:
    """Topology + server + process plumbing."""

    def __init__(
        self,
        *,
        hw: ClusterHW = CLUSTER,
        pipeline_replication: bool = True,
        smart_skipping: bool = True,
        control_latency: Optional[float] = None,
        tcp_compression: Optional[float] = None,
        window: int = DEFAULT_WINDOW,
        chunk_bytes: Optional[float] = DEFAULT_CHUNK_BYTES,
        tcp_streams: int = 1,
        max_sources: int = 4,
        scheduler: str = "least_loaded",
        work_stealing: bool = True,
        swarm: bool = True,
        wan_codec: Optional[str] = None,
        wan_delta: bool = True,
        delta_kept_frac: float = 1.0,
        codec_dtype: str = "float32",
        log: Optional[OpLog] = None,
        telemetry: bool = False,
        retry_policy: Optional[RetryPolicy] = None,
        faults: Optional[FaultPlan] = None,
        quarantine_threshold: int = 3,
        quarantine_probation: float = 30.0,
    ) -> None:
        #: DEPRECATED — ``tcp_compression`` was a hand-set cross-DC
        #: wire-byte scalar whose docstring claimed the int8 ratio while
        #: the default (1.0) compressed nothing. Wire bytes are now
        #: derived from the *negotiated codec*'s actual size formula
        #: (``wan_codec``, default "int8"; see repro_torch.transfer.codec).
        #: Passing the legacy knob preserves the old byte accounting
        #: EXACTLY: the scalar is applied to every WAN TCP flow —
        #: including resharded interval flows, which codec negotiation
        #: keeps raw — and codec-based negotiation is disabled (raw)
        #: unless ``wan_codec`` is also passed explicitly. A fixed-ratio
        #: codec (``wan_codec="fixed:<r>"``) is the non-deprecated way to
        #: model a flat ratio on same-layout WAN pulls.
        self._legacy_tcp_compression: Optional[float] = None
        if tcp_compression is not None:
            warnings.warn(
                "SimCluster(tcp_compression=...) is deprecated; pass "
                'wan_codec="fixed:<ratio>" (or the default "int8") instead',
                DeprecationWarning,
                stacklevel=2,
            )
            if tcp_compression < 1.0:
                self._legacy_tcp_compression = float(tcp_compression)
            if wan_codec is None:
                wan_codec = "raw"
        if wan_codec is None:
            wan_codec = "int8"
        #: wire codec the server negotiates for WAN-crossing slices
        self.wan_codec = wan_codec
        #: delta negotiation knob (see ReferenceServer) and the modeled
        #: version correlation: the fraction of quantization rows that
        #: changed between successive versions. The sim moves no real
        #: bytes, so the delta wire ratio is this knob fed through the
        #: codec's exact size formula (wire_nbytes_at) — 1.0 is the
        #: codec's worst case (every row changed).
        self.wan_delta = bool(wan_delta)
        self.delta_kept_frac = float(delta_kept_frac)
        #: element dtype the fluid simulator assumes when computing a
        #: codec's wire ratio (real manifests carry per-tensor dtypes;
        #: sim manifests are size-only stand-ins for float weights)
        self.codec_dtype = codec_dtype
        #: deprecated alias, kept readable for legacy callers
        self.tcp_compression = 1.0 if tcp_compression is None else tcp_compression
        #: (codec, id(manifest)) -> ratio; entries are evicted by a
        #: weakref finalizer when the manifest is collected, so the cache
        #: neither pins dead replicas' manifests nor outlives id reuse
        self._ratio_cache: Dict[Tuple[str, int], float] = {}
        #: windowed data plane: concurrent unit flows per destination shard
        #: (RDMA/PCIe paths); units above ``chunk_bytes`` are split into
        #: sub-unit byte-range flows. ``window=1`` + ``chunk_bytes=None``
        #: reproduces the pre-scheduler one-flow-at-a-time loop exactly.
        self.window = max(1, window)
        self.chunk_bytes = chunk_bytes if chunk_bytes and chunk_bytes > 0 else None
        #: cross-DC TCP concurrency: streams per shard for WAN fetches.
        #: Kept at 1 by default to preserve the paper-calibrated 2.5 s
        #: seeding transfer (5.4); raising it multi-streams the VPC link.
        self.tcp_streams = max(1, tcp_streams)
        self.env = SimEnv()
        self.net = SimNetwork(self.env)
        #: telemetry recorder on the simulator's virtual clock; stays the
        #: shared disabled singleton unless ``telemetry=True`` so the hot
        #: generator paths record nothing by default. Stall-time
        #: decomposition (stall_parts) is always maintained — it is pure
        #: float accounting on windows the stall counters already track.
        self.recorder = (
            obs.Recorder(clock=lambda: self.env.now) if telemetry else obs.DISABLED
        )
        self.hw = hw
        self.control_latency = (
            hw.control_latency if control_latency is None else control_latency
        )
        self.server = ReferenceServer(
            heartbeat_timeout=hw.heartbeat_timeout,
            pipeline_replication=pipeline_replication,
            smart_skipping=smart_skipping,
            scheduler=scheduler,
            max_sources=max_sources,
            work_stealing=work_stealing,
            # swarm replication: in-progress replicas serve their completed
            # prefix as sources; ``swarm=False`` reproduces the pre-swarm
            # (PR 2) scheduler exactly (benchmarks' parity knob)
            swarm=swarm,
            # chunking disabled means no unit is "giant" to the scheduler:
            # it must not plan around chunk-spreading the data plane will
            # never perform (None would select the server's default hint)
            chunk_hint=(
                self.chunk_bytes if self.chunk_bytes is not None else math.inf
            ),
            # wire codec for WAN-crossing slices (repro_torch.transfer.codec):
            # the sim derives fluid wire bytes from the negotiated
            # codec's size formula per manifest (codec_ratio below)
            wan_codec=wan_codec,
            wan_delta=wan_delta,
            # gray-failure classifier: transient/corrupt evidence
            # strike-counts toward source quarantine instead of eviction
            quarantine_threshold=quarantine_threshold,
            quarantine_probation=quarantine_probation,
            # fault tolerance: replayable op log; crash_and_recover()
            # rebuilds a bit-identical controller from it mid-run
            log=log,
        )
        self.log = log
        self.server.add_watcher(self.env.state_notify)
        self._workers: Dict[Tuple[str, int], SimWorker] = {}
        self._node_seq = itertools.count()
        self.replicas: Dict[str, "SimReplica"] = {}
        #: self-healing knobs (per-read deadline, retry backoff, hedging)
        self.retry_policy = (
            DEFAULT_RETRY_POLICY if retry_policy is None else retry_policy
        )
        #: hedged reads + read-deadline watchdogs are gated off unless the
        #: caller opted in (a fault plan or an explicit policy): they add
        #: wakeup events that would perturb the calibrated healthy-path
        #: benchmark timings
        self._hedging = retry_policy is not None or faults is not None
        self.faults: Optional[SimFaultInjector] = None
        if faults is not None:
            self.install_faults(faults)

    # -- topology -----------------------------------------------------------------

    def _make_worker(
        self, replica: str, shard_idx: int, datacenter: str, node: str, is_spot: bool
    ) -> SimWorker:
        hw = self.hw
        wid = f"{replica}/shard{shard_idx}"
        w = SimWorker(
            worker_id=wid,
            node=node,
            datacenter=datacenter,
            up=self.net.link(f"{node}/{wid}:up", hw.rdma_per_shard),
            down=self.net.link(f"{node}/{wid}:down", hw.rdma_per_shard),
            pcie=self.net.link(f"{node}/{wid}:pcie", hw.pcie),
            vpc_up=self.net.link(f"{node}:vpc_up", hw.vpc_per_node),
            vpc_down=self.net.link(f"{node}:vpc_down", hw.vpc_per_node),
            is_spot=is_spot,
        )
        self._workers[(replica, shard_idx)] = w
        return w

    def worker(self, replica: str, shard_idx: int) -> SimWorker:
        # offload twins live on the origin replica's nodes (CPU memory)
        key = (replica, shard_idx)
        if key not in self._workers and replica.endswith("@offload"):
            origin = replica[: -len("@offload")]
            return self._workers[(origin, shard_idx)]
        return self._workers[key]

    def add_replica(
        self,
        model: str,
        name: str,
        num_shards: int,
        *,
        datacenter: str = "dc0",
        nodes: Optional[Sequence[str]] = None,
        shards_per_node: int = 8,
        is_spot: bool = False,
        retain: Optional[object] = None,
        offload_seeding: bool = False,
        unit_bytes: Sequence[int] = (),
        global_unit_bytes: Optional[Sequence[int]] = None,
    ) -> "SimReplica":
        """``unit_bytes`` sizes one shard's units directly (same-layout
        replicas only); ``global_unit_bytes`` instead sizes the *global*
        model's units and slices them over ``num_shards`` — replicas
        created from the same global sizes with different shard counts
        reshard into each other."""
        rep = SimReplica(
            cluster=self,
            model=model,
            name=name,
            num_shards=num_shards,
            datacenter=datacenter,
            nodes=nodes,
            shards_per_node=shards_per_node,
            is_spot=is_spot,
            retain=retain,
            offload_seeding=offload_seeding,
            unit_bytes=list(unit_bytes),
            global_unit_bytes=(
                None if global_unit_bytes is None else list(global_unit_bytes)
            ),
        )
        self.replicas[name] = rep
        return rep

    # -- wire codecs (fluid byte accounting) ---------------------------------------

    def codec_ratio(self, codec: str, manifest: ShardManifest) -> float:
        """Wire-bytes / payload-bytes multiplier of ``codec`` over one
        shard manifest, from the codec's actual size formula (sim
        manifests are size-only, so elements are assumed ``codec_dtype``).
        Cached per (codec, manifest); a finalizer drops the entry when
        the manifest is garbage collected (id reuse is impossible while
        the entry exists, and churning replicas don't grow the cache)."""
        key = (codec, id(manifest))
        hit = self._ratio_cache.get(key)
        if hit is not None:
            return hit
        ratio = codec_lib.wire_ratio(
            codec_lib.get_codec(codec),
            (u.nbytes for u in manifest.units),
            self.codec_dtype,
            # version correlation for delta codecs; fixed per cluster, so
            # the (codec, manifest) cache key stays sufficient
            delta_kept_frac=self.delta_kept_frac,
        )
        self._ratio_cache[key] = ratio
        weakref.finalize(manifest, self._ratio_cache.pop, key, None)
        return ratio

    # -- failure injection ------------------------------------------------------------

    def crash_and_recover(self) -> "ReferenceServer":
        """Controller failure: kill the server and swap in one recovered
        from the op log (+ compaction snapshot).

        The swap is atomic in virtual time — the crash-sweep harness
        triggers it from the op log's ``on_append`` hook, i.e. at an
        exact op boundary — so sim processes never observe a dead
        controller: their next call lands on the recovered server, which
        is bit-identical to the crashed one up to the committed log.
        (An op in flight at the crash instant finishes against the dead
        server's discarded state; its record is already in the log, so
        the recovered server has applied the same mutation.) The threaded
        client exercises the asynchronous wait-for-failover path instead;
        see ``TensorHubClient.failover``."""
        if self.log is None:
            raise TensorHubError(
                "SimCluster built without an op log cannot recover its "
                "controller; pass log=OpLog(...)"
            )
        self.server.crash()
        new = failover_lib.recover(self.log)
        self.server = new
        new.add_watcher(self.env.state_notify)
        self.env.state_notify()
        return new

    def install_faults(self, plan: FaultPlan) -> "SimFaultInjector":
        """Arm a deterministic gray-fault schedule on this cluster (and
        enable the self-healing machinery — hedged reads, read-deadline
        watchdogs — that a faulted run is meant to exercise)."""
        inj = SimFaultInjector(self, plan)
        inj.install()
        self.faults = inj
        self._hedging = True
        return inj

    def kill_replica(self, name: str) -> None:
        """Spot preemption / node failure: immediate, no grace (5.3)."""
        rep = self.replicas.get(name)
        if rep is not None:
            for s in rep.shards:
                s.worker.alive = False
                s.dead = True
        # flows from/to the victim die; readers notice after the per-read
        # deadline (retry_policy.fail_detect, default = the RDMA timeout)
        self.net.kill_flows(
            lambda f: f.tag.startswith(f"{name}/") or f"->{name}/" in f.tag,
            notice_delay=self.retry_policy.fail_detect,
        )
        # the server learns via missed heartbeats
        self.env.schedule(self.hw.heartbeat_timeout, lambda: self._server_fail(name))
        self._notify_progress_keys(name)

    def _server_fail(self, name: str) -> None:
        for model in list(self.server._models):  # noqa: SLF001 — harness hook
            try:
                self.server.fail_replica(model, name, reason="heartbeat timeout")
            except TensorHubError:
                pass
        self._notify_progress_keys(name)

    def _notify_progress_keys(self, name: str) -> None:
        """Wake every waiter keyed on a dying replica. The shard count is
        derived from the cluster (or, for server-only replicas, from the
        server's registration) rather than a fixed fallback, and a
        predicate sweep catches any remaining keys (control keys, stale
        layouts) so >64-shard replicas cannot miss wakeups."""
        rep = self.replicas.get(name)
        n = rep.num_shards if rep is not None else None
        if n is None:
            for st in self.server._models.values():  # noqa: SLF001 — harness hook
                info = st.replicas.get(name)
                if info is not None:
                    n = info.num_shards
                    break
        names = (name, offload_name(name))
        if n is not None:
            for i in range(n):
                for nm in names:
                    self.env.key_notify(("progress", nm, i))
        self.env.key_notify_where(
            lambda k: isinstance(k, tuple) and len(k) >= 2 and k[1] in names
        )

    # -- metrics -------------------------------------------------------------------------

    def total_stall(self, replicas: Optional[Sequence[str]] = None) -> float:
        names = self.replicas.keys() if replicas is None else replicas
        return sum(
            s.worker.total_stall for n in names for s in self.replicas[n].shards
        )

    def per_worker_stalls(self, replicas: Sequence[str]) -> List[float]:
        return [s.worker.total_stall for n in replicas for s in self.replicas[n].shards]

    def stall_decomposition(
        self, replicas: Optional[Sequence[str]] = None
    ) -> Dict[str, float]:
        """Aggregate stall decomposition over the given replicas (all by
        default): total stall split into the canonical plan_wait / wire /
        decode / verify / control components. Components sum exactly to
        :meth:`total_stall` for the same replica set."""
        names = self.replicas.keys() if replicas is None else replicas
        out = {k: 0.0 for k in obs.STALL_COMPONENTS}
        for n in names:
            for s in self.replicas[n].shards:
                for k, v in s.worker.stall_parts.items():
                    out[k] += v
        return out

    def link_class_bytes(self) -> Dict[str, float]:
        """Wire bytes moved per link class ("up"/"down" RDMA NICs,
        "vpc_up"/"vpc_down" WAN gateways, "pcie" offload lanes),
        aggregated from the fluid network's per-link byte counters. The
        threaded plane exposes matching classes on
        ``LocalTransport.wire_bytes`` ("vpc_up"/"pcie"/"rdma") —
        benchmarks assert sim-vs-threaded WAN parity from these counters
        instead of recomputing bytes by hand."""
        out: Dict[str, float] = {}
        for tag, b in self.net.link_bytes.items():
            cls = tag.rsplit(":", 1)[-1]
            out[cls] = out.get(cls, 0.0) + b
        return out

    def run(self, until: float = math.inf) -> float:
        return self.env.run(until)


class SimShard:
    """Generator-based mirror of ``repro_torch.core.client.ShardHandle``."""

    def __init__(self, replica: "SimReplica", shard_idx: int, worker: SimWorker) -> None:
        self.rep = replica
        self.idx = shard_idx
        self.worker = worker
        self.dead = False
        self._op = itertools.count()
        self._off_op = itertools.count(1_000_000)
        self._seeding: set = set()
        # stall decomposition accounting (pure observation: no events are
        # created or reordered). _ctrl_spent accumulates control-latency
        # yields; the wire tracker maintains the union of this shard's
        # in-flight flow intervals so overlapping windowed flows are not
        # double-counted.
        self._ctrl_spent = 0.0
        self._wire_active = 0
        self._wire_since = 0.0
        self._wire_spent = 0.0
        #: exposed fused-decode time (the backlog tail not hidden under
        #: in-flight interval flows; see _g_pull_resharded)
        self._decode_spent = 0.0

    # plumbing ------------------------------------------------------------------

    @property
    def env(self) -> SimEnv:
        return self.rep.cluster.env

    @property
    def server(self) -> ReferenceServer:
        return self.rep.cluster.server

    @property
    def hw(self) -> ClusterHW:
        return self.rep.cluster.hw

    def _ctrl(self) -> SimEvent:
        # the caller always yields this event immediately, so crediting
        # the latency at creation time keeps the control-time ledger
        # aligned with the stall windows that bracket it
        self._ctrl_spent += self.rep.cluster.control_latency
        return self.env.timeout(self.rep.cluster.control_latency)

    # stall-decomposition ledger (see SimWorker.stall_parts) ----------------

    def _wire_begin(self) -> None:
        if self._wire_active == 0:
            self._wire_since = self.env.now
        self._wire_active += 1

    def _wire_end(self) -> None:
        self._wire_active -= 1
        if self._wire_active == 0:
            self._wire_spent += self.env.now - self._wire_since

    def _wire_snapshot(self) -> float:
        """Wire-time ledger including any currently open interval."""
        if self._wire_active > 0:
            return self._wire_spent + (self.env.now - self._wire_since)
        return self._wire_spent

    def _stall_mark(self) -> Tuple[float, float, float, float]:
        return (
            self.env.now,
            self._ctrl_spent,
            self._wire_snapshot(),
            self._decode_spent,
        )

    def _stall_account(self, mark: Tuple[float, float, float, float]) -> None:
        t0, c0, w0, d0 = mark
        self.worker.stall_attribute(
            self.env.now - t0,
            self._ctrl_spent - c0,
            self._wire_snapshot() - w0,
            self._decode_spent - d0,
        )

    # Table-2 ops (generators) -----------------------------------------------------

    def g_open(self) -> Generator:
        info = WorkerInfo(
            worker_id=self.worker.worker_id,
            node=self.worker.node,
            datacenter=self.worker.datacenter,
            is_spot=self.worker.is_spot,
        )
        yield self._ctrl()
        self.server.open(
            self.rep.model,
            self.rep.name,
            self.rep.num_shards,
            self.idx,
            worker=info,
            retain=self.rep.retain,
        )
        self.server.register(self.rep.model, self.rep.name, self.idx)

    def g_publish(self, version: int) -> Generator:
        yield self._ctrl()
        self.server.publish(
            self.rep.model,
            self.rep.name,
            self.idx,
            version,
            self.rep.manifest_for(self.idx),
            op_id=next(self._op),
        )
        rec = self.rep.cluster.recorder
        if rec.enabled:
            rec.event("publish", track=self.worker.worker_id, version=version)
        self.env.key_notify(("progress", self.rep.name, self.idx))

    def g_unpublish(self) -> Generator:
        yield self._ctrl()
        res = self.server.unpublish(
            self.rep.model, self.rep.name, self.idx, op_id=next(self._op)
        )
        if res.offload_required and res.offload_version is not None:
            yield from self._g_offload_copy(res.offload_version)
        yield from self._g_wait_drained()

    def g_replicate(self, spec, *, stall: bool = True) -> Generator:
        mark = None
        if stall:
            self.worker.stall_begin(self.env.now)
            mark = self._stall_mark()
        op = next(self._op)
        yield self._ctrl()
        assignment = self.server.begin_replicate(
            self.rep.model, self.rep.name, self.idx, spec, op_id=op
        )
        while assignment is None:
            yield self.env.state_wait()
            assignment = self.server.redeem(self.rep.model, self.rep.name, op_id=op)
        rec = self.rep.cluster.recorder
        if rec.enabled:
            rec.event(
                "assignment", track=self.worker.worker_id,
                version=assignment.version, epoch=assignment.epoch,
                sources=[s.source for s in assignment.sources],
                codec=assignment.codec,
            )
        yield from self._g_pull(assignment, dest=self.rep.name)
        if stall:
            self.worker.stall_end(self.env.now)
            self._stall_account(mark)
        return assignment.version

    def g_update(self, spec="latest", *, stall: bool = True) -> Generator:
        """One update() poll; returns True if the weights changed."""
        op = next(self._op)
        yield self._ctrl()
        d = self.server.begin_update(
            self.rep.model,
            self.rep.name,
            self.idx,
            spec,
            op_id=op,
            offload_seeding=self.rep.offload_seeding,
        )
        if d.seed_started and d.seed_version is not None:
            if d.seed_version not in self._seeding:
                self._seeding.add(d.seed_version)
                self.env.process(self._g_seed_pull(d.seed_version))
        if not d.updated:
            return False
        mark = None
        if stall:
            self.worker.stall_begin(self.env.now)
            mark = self._stall_mark()
        if d.offload_required and d.offload_version is not None:
            yield from self._g_offload_copy(d.offload_version)
        yield from self._g_wait_drained()
        assert d.assignment is not None
        rec = self.rep.cluster.recorder
        if rec.enabled:
            rec.event(
                "assignment", track=self.worker.worker_id,
                version=d.assignment.version, epoch=d.assignment.epoch,
                sources=[s.source for s in d.assignment.sources],
                codec=d.assignment.codec,
            )
        yield from self._g_pull(d.assignment, dest=self.rep.name)
        if stall:
            self.worker.stall_end(self.env.now)
            self._stall_account(mark)
        return True

    # internals ---------------------------------------------------------------------

    def _g_wait_drained(self) -> Generator:
        while not self.server.finish_unpublish(self.rep.model, self.rep.name):
            yield self.env.state_wait()

    def _g_timed_flow(self, ev, name, source, nbytes, codec, transport) -> Generator:
        """Yield a flow event under the wire ledger (and a span when the
        cluster recorder is enabled). Pure observation: the event passes
        through unchanged, so scheduling and byte accounting are
        bit-identical to yielding the flow directly."""
        rec = self.rep.cluster.recorder
        sp = None
        if rec.enabled:
            sp = rec.span(
                name, track=self.worker.worker_id, source=source,
                bytes=nbytes, codec=codec, transport=transport,
            )
        self._wire_begin()
        try:
            yield ev
        finally:
            self._wire_end()
            if sp is not None:
                sp.end()

    def _g_offload_copy(self, version: int) -> Generator:
        """Retention offload: GPU -> CPU over PCIe, then publish_offload."""
        nbytes = self.rep.manifest_for(self.idx).total_bytes
        yield from self._g_timed_flow(
            self.rep.cluster.net.flow(
                nbytes, [self.worker.pcie], tag=f"{self.rep.name}/s{self.idx}:offload"
            ),
            "offload_copy", self.rep.name, nbytes, "raw", "pcie",
        )
        yield self._ctrl()
        self.server.publish_offload(
            self.rep.model,
            self.rep.name,
            self.idx,
            version,
            self.rep.manifest_for(self.idx),
            op_id=next(self._op),
        )
        self.env.key_notify(("progress", offload_name(self.rep.name), self.idx))

    def _flow_for_bytes(
        self,
        src_replica: str,
        src_shard: int,
        nbytes: float,
        transport: str,
        dest_name: str,
        codec: str = "raw",
    ) -> SimEvent:
        cluster = self.rep.cluster
        src_w = cluster.worker(src_replica, src_shard)
        dst_w = self.worker
        hw = self.hw
        if src_w.node == dst_w.node:
            links = [dst_w.pcie]  # local CPU<->GPU consumption (seed twins)
            cap = hw.pcie
        elif transport == "tcp":
            links = [src_w.vpc_up, dst_w.vpc_down]
            # WAN TCP streams are stream-limited before they are NIC-limited
            cap = min(hw.tensorhub_tcp_eff * hw.vpc_per_node, hw.tcp_stream_per_shard)
        else:
            links = [src_w.up, dst_w.down]
            cap = hw.tensorhub_rdma_eff * hw.rdma_per_shard
        legacy = cluster._legacy_tcp_compression
        if legacy is not None and transport == "tcp":
            # deprecated tcp_compression scalar: the pre-codec behavior
            # verbatim — every WAN TCP flow scaled, resharded interval
            # flows included (codec negotiation keeps those raw)
            nbytes = nbytes * legacy
        elif codec != "raw":
            # the negotiated wire codec moves fewer (or framed) bytes; the
            # multiplier comes from the codec's size formula over this
            # shard's manifest, not a hand-set scalar
            nbytes = nbytes * cluster.codec_ratio(
                codec, self.rep.manifest_for(self.idx)
            )
        tag = f"{src_replica}/s{src_shard}->{dest_name}/s{self.idx}"
        ev = cluster.net.flow(
            nbytes, links, rate_cap=cap, latency=hw.unit_latency, tag=tag
        )
        if cluster.faults is not None and cluster.faults.flaky_hit(
            src_replica, self.env.now
        ):
            # injected flake: the flow starts, then dies almost at once
            # with a *transient* kill (the endpoint is fine — the reader
            # backs off and retries). Scheduled past the flow's start
            # latency so kill_flows sees it attached.
            self.env.schedule(
                hw.unit_latency * 2,
                lambda: cluster.net.kill_flows(
                    lambda f: f.event is ev, transient=True
                ),
            )
        return ev

    def _g_pull(self, assignment: Assignment, *, dest: str) -> Generator:
        """The pipeline-replication read loop (4.3.3) in virtual time.

        Dispatches per assignment: same-layout sources stream whole units
        (multi-source plans partition the unit list across replicas and
        pull them through a windowed, chunked flow pool); a source with a
        different shard count runs the resharding plan (striped interval
        flows from *all* source shards). Progress counts completed
        destination units either way, so a re-route or re-partition
        mid-transfer may switch modes and resume (4.5).
        """
        version = assignment.version
        completed: set = set()  # out-of-order completions, kept across re-plans
        rejects: Dict[int, int] = {}  # unit -> checksum rejects, across re-plans
        while True:
            try:
                if assignment.resharded:
                    yield from self._g_pull_resharded(assignment, dest)
                else:
                    yield from self._g_pull_units(
                        assignment, dest, completed, rejects
                    )
                break
            except _SimReplan:
                assignment = yield from self._g_refetch(dest)
            except _SimSourceLost as e:
                assignment = yield from self._g_reroute(dest, e.source, e.evidence)
        yield self._ctrl()
        self.server.complete_replicate(
            self.rep.model,
            dest,
            self.idx,
            version,
            op_id=next(self._off_op) if dest != self.rep.name else next(self._op),
        )

    def _g_await_source_unit(
        self, source: str, version: int, src_shard: int, needed: int
    ) -> Generator:
        """Wait until the source shard's progress counter exceeds
        ``needed``. Purely keyed wakeups backed by the event loop's long
        safety tick (SimEnv.safety_tick) instead of the old 0.5 s polling
        timeout (measurable wakeup overhead at large fan-out — and the
        stale poll timers inflated ``env.now`` after runs finished)."""
        env = self.env
        while True:
            if self.dead:
                raise PreemptedError(self.worker.worker_id)
            try:
                avail = self.server.shard_progress(
                    self.rep.model, source, version, src_shard
                )
            except (StaleHandleError, TensorHubError):
                raise _SimSourceLost(source)
            if avail > needed:
                return avail
            yield env.key_wait(("progress", source, src_shard))

    # -- same-layout unit pulls: windowed, chunked, multi-source ----------------

    def _plane_knobs(self, slices: List[SourceSlice]) -> Tuple[int, Optional[float]]:
        """Window depth and chunk threshold for this pull. WAN TCP pulls
        follow ``tcp_streams`` (default 1: preserves the paper-calibrated
        single-stream seeding transfer); RDMA/PCIe pulls use the cluster's
        window/chunk knobs."""
        cl = self.rep.cluster
        if any(sl.transport == "tcp" for sl in slices):
            window = cl.tcp_streams
            chunk = cl.chunk_bytes if cl.tcp_streams > 1 else None
        else:
            window = cl.window
            chunk = cl.chunk_bytes
        return window, chunk

    def _g_pull_units(
        self,
        assignment: Assignment,
        dest: str,
        completed: Optional[set] = None,
        rejects: Optional[Dict[int, int]] = None,
    ) -> Generator:
        version = assignment.version
        units = self.rep.manifest_for(self.idx).units
        if completed is None:
            completed = set()
        if rejects is None:
            rejects = {}
        while True:
            done = self.server.shard_progress(self.rep.model, dest, version, self.idx)
            if done >= len(units):
                return
            # units completed out of order survive re-plans (their bytes
            # are final); only the uncompleted ones are re-fetched
            completed -= set(range(done))
            slices = assignment.slices(len(units))
            window, chunk = self._plane_knobs(slices)
            if window <= 1 and chunk is None and len(slices) == 1:
                yield from self._g_pull_units_seq(assignment, dest, rejects)
                return
            yield from self._g_pull_units_windowed(
                assignment, dest, slices, done, window, chunk, completed, rejects
            )

    def _g_pull_units_seq(
        self,
        assignment: Assignment,
        dest: str,
        rejects: Optional[Dict[int, int]] = None,
    ) -> Generator:
        """The pre-scheduler data plane: one whole-unit flow at a time from
        a single source. Kept verbatim as the window=1/chunking-off
        reference path (benchmarks compare against it bit-for-bit; the
        retry/corrupt branches are reachable only with faults armed)."""
        env = self.env
        version = assignment.version
        manifest = self.rep.manifest_for(self.idx)
        units = manifest.units
        source = assignment.source
        transport = assignment.transport
        codec = assignment.codec
        cl = self.rep.cluster
        policy = cl.retry_policy
        if rejects is None:
            rejects = {}
        done = self.server.shard_progress(self.rep.model, dest, version, self.idx)
        while done < len(units):
            if self.dead:
                raise PreemptedError(self.worker.worker_id)
            avail = yield from self._g_await_source_unit(
                source, version, self.idx, done
            )
            for i in range(done, avail):
                attempt = 0
                while True:
                    try:
                        yield from self._g_timed_flow(
                            self._flow_for_bytes(
                                source, self.idx, units[i].nbytes, transport,
                                dest, codec=codec,
                            ),
                            "flow", source, units[i].nbytes, codec, transport,
                        )
                        break
                    except FlowKilled as e:
                        if self.dead:
                            raise PreemptedError(self.worker.worker_id)
                        if not e.transient or attempt >= policy.retry_limit:
                            raise _SimSourceLost(
                                source,
                                evidence="transient" if e.transient else "fatal",
                            )
                        attempt += 1
                        yield env.timeout(policy.backoff(attempt))
                if cl.faults is not None and cl.faults.corrupt_hit(
                    source, env.now
                ):
                    # injected corruption: the destination-side checksum
                    # rejects the unit; report and re-plan rather than
                    # abort, bounded per unit (see the threaded plane)
                    rejects[i] = rejects.get(i, 0) + 1
                    if rejects[i] > policy.retry_limit:
                        raise TensorHubError(
                            f"unit {units[i].name}: {rejects[i]} checksum "
                            "rejects across re-plans; data is corrupt at "
                            "every source"
                        )
                    raise _SimSourceLost(source, evidence="corrupt")
                done += 1
                self.server.update_progress(
                    self.rep.model, dest, self.idx, version, done
                )
                rec = self.rep.cluster.recorder
                if rec.enabled:
                    rec.event("prefix_advance", track=self.worker.worker_id, done=done)
                env.key_notify(("progress", dest, self.idx))

    def _build_tasks(
        self,
        slices: List[SourceSlice],
        units: Sequence[TransferUnit],
        done: int,
        chunk: Optional[float],
        completed: set,
    ) -> List[_Task]:
        """Expand the plan's unit ranges into an ordered task list. Units
        above the chunk threshold become byte-range tasks; with several
        sources the chunks of one unit are owner-hinted round-robin across
        *all* of them — same-layout replicas hold identical bytes, so a
        single giant tensor can aggregate every source uplink instead of
        binding to its range owner. Units in ``completed`` (finished out
        of order before a re-plan) are skipped."""
        owners: Dict[int, int] = {}
        for k, sl in enumerate(slices):
            for ui in range(max(sl.start_unit, done), min(sl.stop_unit, len(units))):
                owners.setdefault(ui, k)
        tasks: List[_Task] = []
        rr = 0
        for ui in range(done, len(units)):
            if ui in completed:
                continue
            k = owners.get(ui, 0)
            nbytes = units[ui].nbytes
            if chunk is not None and nbytes > chunk:
                n_parts = int(math.ceil(nbytes / chunk))
                per = nbytes / n_parts  # fluid bytes: equal fractional chunks
                for j in range(n_parts):
                    tgt = (rr + j) % len(slices) if len(slices) > 1 else k
                    tasks.append(_Task(ui, j * per, per, tgt))
                rr += n_parts
            else:
                tasks.append(_Task(ui, 0, nbytes, k))
        return tasks

    def _g_pull_units_windowed(
        self,
        assignment: Assignment,
        dest: str,
        slices: List[SourceSlice],
        done: int,
        window: int,
        chunk: Optional[float],
        completed: set,
        rejects: Optional[Dict[int, int]] = None,
    ) -> Generator:
        """Windowed multi-source pull: one worker process per source slice,
        a shared slot pool capping in-flight flows at ``window`` per shard,
        and in-order prefix advancement of the progress counter (units may
        *complete* out of order across sources; the counter — which gates
        downstream pipeline chains and mid-transfer re-routing — only ever
        advances over a contiguous prefix).

        Execution is availability-aware: the server's unit ranges are load
        hints, not bindings. A worker claims tasks from its own range
        first, then steals unclaimed tasks from the global tail — but only
        tasks its source can already serve (progress gating). Pipeline
        chaining off partial replicas and bandwidth aggregation across
        published ones fall out of the same loop."""
        env = self.env
        version = assignment.version
        units = self.rep.manifest_for(self.idx).units
        tasks = self._build_tasks(slices, units, done, chunk, completed)
        if not tasks:
            return
        remaining: Dict[int, int] = {}
        for t in tasks:
            remaining[t.unit] = remaining.get(t.unit, 0) + 1
        state = {
            "done": done,
            "completed": completed,  # shared with the caller: survives re-plans
            "remaining": remaining,
            "tasks": tasks,
            "claimed": [False] * len(tasks),
            "unclaimed": len(tasks),
            "scan": 0,  # first possibly-unclaimed task index
            "stop": None,  # None | "replan" | BaseException
            "epoch": assignment.epoch,
            # self-healing state --------------------------------------
            "rejects": rejects if rejects is not None else {},
            "taskdone": [False] * len(tasks),  # completion claims
            "ntaskdone": 0,
            "inflight": {},  # task idx -> (start, source, worker idx)
            "durations": [],  # completed flow durations (hedge baseline)
            "hedged": set(),  # task idxs already duplicated once
            "finished": False,  # parent's signal to the watchdog
        }
        ctl = ("ctl", dest, self.idx)
        slots = _SimSlots(env, window)
        children = [
            env.process(
                self._g_source_worker(k, sl, state, slots, dest, version, ctl)
            )
            for k, sl in enumerate(slices)
        ]
        if self.rep.cluster._hedging:
            # faulted/healing runs only: per-read deadline watchdog (adds
            # timer events, so gated off the calibrated healthy paths)
            env.process(self._g_span_watchdog(state, dest, version, ctl))
        done_ev = SimEvent(env)
        pending = len(children)

        def on_child(ev: SimEvent) -> None:
            nonlocal pending
            if ev.error is not None and not isinstance(state["stop"], BaseException):
                state["stop"] = ev.error
                env.key_notify(ctl)
            pending -= 1
            if pending == 0:
                done_ev.succeed()

        for c in children:
            c.add_callback(on_child)
        yield done_ev
        state["finished"] = True
        if self.dead:
            raise PreemptedError(self.worker.worker_id)
        stop = state["stop"]
        if isinstance(stop, BaseException):
            raise stop
        if stop == "replan":
            raise _SimReplan()

    def _g_source_worker(
        self,
        k: int,
        sl: SourceSlice,
        state: dict,
        slots: _SimSlots,
        dest: str,
        version: int,
        ctl: tuple,
    ) -> Generator:
        env = self.env
        cl = self.rep.cluster
        policy = cl.retry_policy
        hedging = cl._hedging
        rec = cl.recorder
        tasks: List[_Task] = state["tasks"]
        claimed: List[bool] = state["claimed"]
        taskdone: List[bool] = state["taskdone"]
        while True:
            if state["stop"] is not None:
                return
            if self.dead:
                raise PreemptedError(self.worker.worker_id)
            # pick up server-side re-partitions (work stealing, re-routes)
            try:
                ep = self.server.assignment_epoch(self.rep.model, dest, version)
            except (StaleHandleError, TensorHubError):
                return  # dest state gone; the parent unwinds
            if ep != state["epoch"]:
                if state["stop"] is None:
                    state["stop"] = "replan"
                    env.key_notify(ctl)
                return
            if state["ntaskdone"] == len(tasks):
                return
            try:
                avail = self.server.shard_progress(
                    self.rep.model, sl.source, version, self.idx
                )
            except (StaleHandleError, TensorHubError):
                raise _SimSourceLost(sl.source)
            # Global in-order claiming: take the LOWEST-indexed unclaimed
            # task this source can serve. Keeping the in-flight window on
            # the head of the unit list makes the progress *prefix* (which
            # gates downstream pipeline chains) advance at full aggregate
            # rate; claiming ranges out of order would starve relays to
            # 1/window of the bandwidth. Faster/idler sources win more
            # claims, so load balances itself around the server's ranges.
            # The `tasks[i].unit < avail` predicate is ALSO the simulator's
            # never-read-past-source-prefix guard (swarm replication): a
            # claim is legal only for units the source's completed prefix
            # covers, and progress is monotone, so a claimed unit can never
            # outrun its source — in-progress replicas serve exactly their
            # prefix (SourceSlice.ceiling is the plan-time snapshot of it).
            while state["scan"] < len(tasks) and claimed[state["scan"]]:
                state["scan"] += 1
            pick = None
            hedged = False
            for i in range(state["scan"], len(tasks)):
                if not claimed[i] and tasks[i].unit < avail:
                    pick = i
                    break
            if pick is None and hedging:
                # idle with no unclaimed work: duplicate the slowest
                # foreign in-flight flow instead (bounds single-source
                # straggling at roughly the healthy source's speed; the
                # first copy to finish claims the task)
                pick = self._sim_hedge_pick(state, sl, avail, policy)
                if pick is not None:
                    hedged = True
                    if rec.enabled:
                        rec.counter_add(obs.CTR_HEDGES, 1)
                        rec.event(
                            "hedge", track=self.worker.worker_id,
                            source=sl.source, unit=tasks[pick].unit,
                        )
            if pick is None:
                # nothing this source can serve yet: wait for its progress
                # (plus, when hedging, a timer for the next straggler
                # becoming hedge-eligible — a stuck flow notifies nothing)
                waits = [
                    env.key_wait(("progress", sl.source, self.idx)),
                    env.key_wait(ctl),
                ]
                if hedging:
                    delay = self._sim_hedge_delay(state, sl, policy)
                    if delay is not None:
                        waits.append(env.timeout(delay))
                yield env.any_of(*waits)
                continue
            if not hedged:
                claimed[pick] = True
                state["unclaimed"] -= 1
                if state["unclaimed"] == 0:
                    env.key_notify(ctl)  # wake gated siblings so they can exit
            t = tasks[pick]
            yield slots.acquire()
            if state["stop"] is not None or taskdone[pick]:
                slots.release()
                if state["stop"] is not None:
                    return
                continue  # hedge twin finished while we queued for a slot
            started = env.now
            state["inflight"][pick] = (started, sl.source, k)
            attempt = 0
            failed = None
            delivered = False
            try:
                while True:
                    try:
                        yield from self._g_timed_flow(
                            self._flow_for_bytes(
                                sl.source, self.idx, t.nbytes, sl.transport,
                                dest, codec=sl.codec,
                            ),
                            "flow", sl.source, t.nbytes, sl.codec, sl.transport,
                        )
                        delivered = True
                        break
                    except FlowKilled as e:
                        if self.dead:
                            raise PreemptedError(self.worker.worker_id)
                        if e.transient and (
                            state["stop"] is not None or taskdone[pick]
                        ):
                            break  # span drained / hedge twin won: abandon
                        if not e.transient or attempt >= policy.retry_limit:
                            failed = _SimSourceLost(
                                sl.source,
                                evidence="transient" if e.transient else "fatal",
                            )
                            break
                        attempt += 1
                        if rec.enabled:
                            rec.counter_add(obs.CTR_RETRIES, 1)
                            rec.event(
                                "retry", track=self.worker.worker_id,
                                source=sl.source, unit=t.unit, attempt=attempt,
                            )
                        yield env.timeout(policy.backoff(attempt))
                        if state["stop"] is not None or taskdone[pick]:
                            break  # abandoned mid-retry; drop the attempt
            finally:
                cur = state["inflight"].get(pick)
                if cur is not None and cur[2] == k:
                    del state["inflight"][pick]
                slots.release()
            if failed is not None:
                raise failed
            if not delivered:
                # flow abandoned mid-kill/retry: nothing arrived
                if state["stop"] is not None:
                    return
                continue  # hedge twin won while we were backing off
            if taskdone[pick]:
                continue  # hedge twin won the race; identical bytes, drop
            if cl.faults is not None and cl.faults.corrupt_hit(sl.source, env.now):
                # injected corruption: the destination-side checksum
                # rejects the unit; report + re-plan, bounded per unit
                u = t.unit
                state["rejects"][u] = state["rejects"].get(u, 0) + 1
                if state["rejects"][u] > policy.retry_limit:
                    raise TensorHubError(
                        f"unit {u}: {state['rejects'][u]} checksum rejects "
                        "across re-plans; data is corrupt at every source"
                    )
                if rec.enabled:
                    rec.counter_add(obs.CTR_CORRUPT_REJECTS, 1)
                    rec.event(
                        "corrupt_reject", track=self.worker.worker_id,
                        source=sl.source, unit=u,
                    )
                raise _SimSourceLost(sl.source, evidence="corrupt")
            taskdone[pick] = True
            state["ntaskdone"] += 1
            state["durations"].append(env.now - started)
            if state["ntaskdone"] == len(tasks):
                env.key_notify(ctl)  # wake hedging siblings so they can exit
                if hedging and state["inflight"]:
                    # a hedge twin finished last: losers still crawling on
                    # a straggler would pin the span (the parent joins all
                    # workers) — kill their flows with a transient notice
                    cl.net.kill_flows(
                        lambda f: f.tag.endswith(f"->{dest}/s{self.idx}"),
                        transient=True,
                    )
            rem = state["remaining"][t.unit] - 1
            state["remaining"][t.unit] = rem
            if rem == 0:
                state["completed"].add(t.unit)
                advanced = False
                while state["done"] in state["completed"]:
                    state["done"] += 1
                    advanced = True
                if advanced:
                    self.server.update_progress(
                        self.rep.model, dest, self.idx, version, state["done"]
                    )
                    env.key_notify(("progress", dest, self.idx))

    def _sim_hedge_pick(
        self, state: dict, sl: SourceSlice, avail: int, policy: RetryPolicy
    ) -> Optional[int]:
        """Oldest in-flight task worth duplicating onto this idle source:
        running longer than ``hedge_threshold`` x the median completed
        flow, owned by a different source, not already hedged, and within
        this source's served prefix."""
        durs = state["durations"]
        if len(durs) < policy.hedge_min_samples:
            return None
        med = sorted(durs)[len(durs) // 2]
        threshold = policy.hedge_threshold * max(med, 1e-9)
        now = self.env.now
        tasks: List[_Task] = state["tasks"]
        pick = None
        oldest = None
        for ti, (started, src, _k) in state["inflight"].items():
            if src == sl.source or ti in state["hedged"]:
                continue
            if state["taskdone"][ti] or tasks[ti].unit >= avail:
                continue
            age = now - started
            if age >= threshold and (oldest is None or age > oldest):
                oldest = age
                pick = ti
        if pick is not None:
            state["hedged"].add(pick)
        return pick

    def _sim_hedge_delay(
        self, state: dict, sl: SourceSlice, policy: RetryPolicy
    ) -> Optional[float]:
        """Virtual-time delay until the next foreign in-flight flow could
        become hedge-eligible (None when nothing qualifies — then the
        keyed progress/ctl wakeups suffice)."""
        durs = state["durations"]
        if len(durs) < policy.hedge_min_samples:
            return None
        med = sorted(durs)[len(durs) // 2]
        threshold = policy.hedge_threshold * max(med, 1e-9)
        now = self.env.now
        best = None
        for ti, (started, src, _k) in state["inflight"].items():
            if src == sl.source or ti in state["hedged"] or state["taskdone"][ti]:
                continue
            wait = (started + threshold) - now
            if best is None or wait < best:
                best = wait
        if best is None:
            return None
        return max(best, self.hw.unit_latency)

    def _g_span_watchdog(
        self, state: dict, dest: str, version: int, ctl: tuple
    ) -> Generator:
        """Per-read deadline enforcement for one windowed span (faulted /
        healing runs only). A flow in flight past ``fail_detect`` is
        *transient* evidence against its source — reported (rate-limited
        per source) so the server strike-counts toward quarantine. When
        the resulting re-plan bumps the epoch, the watchdog drains the
        span and transiently kills its inbound flows so workers blocked
        on a hung (zero-bandwidth) flow wake up and exit."""
        env = self.env
        cl = self.rep.cluster
        policy = cl.retry_policy
        rec = cl.recorder
        last_report: Dict[str, float] = {}
        tick = max(policy.fail_detect / 2.0, cl.hw.unit_latency)
        while True:
            yield env.timeout(tick)
            if state["finished"] or state["stop"] is not None or self.dead:
                return
            now = env.now
            overdue: List[str] = []
            for ti, (started, src, _k) in list(state["inflight"].items()):
                if state["taskdone"][ti]:
                    continue
                if now - started >= policy.fail_detect:
                    prev = last_report.get(src)
                    if prev is None or now - prev >= policy.fail_detect:
                        last_report[src] = now
                        overdue.append(src)
            for src in overdue:
                if rec.enabled:
                    rec.counter_add(obs.CTR_DEADLINE_REPORTS, 1)
                    rec.event(
                        "read_deadline", track=self.worker.worker_id, source=src
                    )
                try:
                    self.server.report_transfer_failure(
                        self.rep.model, dest, src, "transient", now
                    )
                except (StaleHandleError, TensorHubError):
                    return  # dest state gone; workers unwind on their own
            try:
                ep = self.server.assignment_epoch(self.rep.model, dest, version)
            except (StaleHandleError, TensorHubError):
                return
            if ep != state["epoch"]:
                if state["stop"] is None:
                    state["stop"] = "replan"
                    env.key_notify(ctl)
                cl.net.kill_flows(
                    lambda f: f.tag.endswith(f"->{dest}/s{self.idx}"),
                    transient=True,
                )
                return

    def _g_refetch(self, dest: str) -> Generator:
        """Re-fetch the (re-partitioned) assignment after a plan epoch
        bump; no failure to report."""
        yield self._ctrl()
        while True:
            if self.dead:
                raise PreemptedError(self.worker.worker_id)
            try:
                new = self.server.get_assignment(self.rep.model, dest)
            except StaleHandleError:
                if self.dead:
                    raise PreemptedError(self.worker.worker_id)
                raise
            if new is not None:
                return new
            yield self.env.state_wait()

    def _g_pull_resharded(self, assignment: Assignment, dest: str) -> Generator:
        """Striped cross-layout pull in virtual time: real planner, fluid
        bytes. Each interval flows over the *owning* source shard's NIC,
        so bandwidth aggregates across all source shards exactly as the
        byte accounting says it should.

        The negotiated wire codec rides the plan exactly as in the
        threaded plane: ``reshard_wire_codec`` collapses delta to its
        base, the planner widens reads to the codec's row grid
        (``iv.read_nbytes`` is what flows), and a lossy codec models the
        fused client-side decode as a backlog drained at roughly a third
        of HBM bandwidth — hidden under the next unit's flows, with only
        the tail exposed (ledgered as ``decode`` stall)."""
        from repro_torch.resharding import layout_from_manifests, plan_shard

        codec = codec_lib.reshard_wire_codec(assignment.codec)
        fused = codec != "raw"
        env = self.env
        version = assignment.version
        src_n = assignment.source_shards
        local_manifest = self.rep.manifest_for(self.idx)
        self.server.put_manifest(
            self.rep.model, dest, self.idx, version, local_manifest
        )
        source = assignment.source
        src_manifests = {}
        for s in range(src_n):
            while True:
                m = self.server.replica_manifest(self.rep.model, version, source, s)
                if m is not None:
                    break
                yield env.state_wait()
                if self.dead:
                    raise PreemptedError(self.worker.worker_id)
            src_manifests[s] = m
        src_layout = layout_from_manifests(src_manifests, src_n)
        dst_layout = layout_from_manifests(
            {self.idx: local_manifest}, self.rep.num_shards
        )
        plan = plan_shard(
            src_layout,
            dst_layout,
            self.idx,
            num_dest_units=local_manifest.num_units,
            codec=codec,
        )
        by_unit = plan.intervals_by_unit()
        transport = assignment.transport
        done = self.server.shard_progress(self.rep.model, dest, version, self.idx)
        decode_bw = H100.hbm_bw / 3.0  # fused dequant+gather drain rate
        backlog = 0.0  # decode seconds not yet hidden under flows
        for unit in local_manifest.units[done:]:
            t_unit = env.now
            for iv in by_unit.get(unit.index, []):
                yield from self._g_await_source_unit(
                    source, version, iv.source_shard, iv.source_unit
                )
                try:
                    yield from self._g_timed_flow(
                        self._flow_for_bytes(
                            source, iv.source_shard, iv.read_nbytes, transport,
                            dest, codec=codec,
                        ),
                        "interval_flow", source, iv.read_nbytes, codec,
                        transport,
                    )
                except FlowKilled:
                    if self.dead:
                        raise PreemptedError(self.worker.worker_id)
                    raise _SimSourceLost(source)
            if fused:
                # one-unit lookahead: the previous unit's decode drained
                # while this unit's intervals were in flight
                backlog = max(0.0, backlog - (env.now - t_unit))
                backlog += unit.nbytes / decode_bw
            done += 1
            self.server.update_progress(self.rep.model, dest, self.idx, version, done)
            env.key_notify(("progress", dest, self.idx))
        if backlog > 0.0:
            # the last unit's decode has no flows left to hide under
            t0 = env.now
            yield env.timeout(backlog)
            self._decode_spent += env.now - t0

    def _g_reroute(
        self, dest: str, dead_source: str, evidence: str = "fatal"
    ) -> Generator:
        if self.dead:
            raise PreemptedError(self.worker.worker_id)
        yield self._ctrl()
        self.server.report_transfer_failure(
            self.rep.model, dest, dead_source, evidence, self.env.now
        )
        while True:
            new = self.server.get_assignment(self.rep.model, dest)
            if new is not None:
                return new
            yield self.env.state_wait()
            if self.dead:
                raise PreemptedError(self.worker.worker_id)

    def _g_seed_pull(self, version: int) -> Generator:
        """Background cross-DC fetch into CPU memory (offload seeding,
        4.3.4) — does NOT count as GPU stall."""
        twin = offload_name(self.rep.name)
        while True:
            assignment = self.server.get_assignment(self.rep.model, twin)
            if assignment is not None:
                break
            yield self.env.state_wait()
        yield from self._g_pull(assignment, dest=twin)


class SimReplica:
    """A model-parallel group of SimShards."""

    def __init__(
        self,
        *,
        cluster: SimCluster,
        model: str,
        name: str,
        num_shards: int,
        datacenter: str,
        nodes: Optional[Sequence[str]],
        shards_per_node: int,
        is_spot: bool,
        retain: Optional[object],
        offload_seeding: bool,
        unit_bytes: List[int],
        global_unit_bytes: Optional[List[int]] = None,
    ) -> None:
        self.cluster = cluster
        self.model = model
        self.name = name
        self.num_shards = num_shards
        self.datacenter = datacenter
        self.is_spot = is_spot
        self.retain = retain
        self.offload_seeding = offload_seeding
        self.unit_bytes = unit_bytes
        self.global_unit_bytes = global_unit_bytes
        # manifests declare the cluster's codec dtype so the server's
        # codec negotiation sees the quantizable payload the fluid byte
        # accounting already assumes
        if global_unit_bytes is not None:
            self.manifests = make_layout_manifests(
                global_unit_bytes, num_shards, dtype=cluster.codec_dtype
            )
        else:
            self.manifests = [
                make_manifest(unit_bytes, dtype=cluster.codec_dtype)
            ] * num_shards
        self.manifest = self.manifests[0]
        self.shard_bytes = self.manifests[0].total_bytes
        self.shards: List[SimShard] = []
        for i in range(num_shards):
            node = (
                nodes[i // shards_per_node]
                if nodes is not None
                else f"{datacenter}/{name}-n{i // shards_per_node}"
            )
            w = cluster._make_worker(name, i, datacenter, node, is_spot)
            self.shards.append(SimShard(self, i, w))

    def manifest_for(self, shard_idx: int) -> ShardManifest:
        return self.manifests[shard_idx]

    # -- group-level helpers: run an op on every shard, fire when all done ------------

    def _all(self, gens: List[Generator]) -> SimEvent:
        """Start one process per shard; the returned event fires (with the
        list of per-shard results) when all of them finished. A failing
        shard fails the group event."""
        env = self.cluster.env
        done = SimEvent(env)
        remaining = len(gens)
        results: List[object] = [None] * len(gens)

        def on_finish(i: int) -> Callable[[SimEvent], None]:
            def cb(ev: SimEvent) -> None:
                nonlocal remaining
                if ev.error is not None:
                    done.fail(ev.error)
                    return
                results[i] = ev.value
                remaining -= 1
                if remaining == 0:
                    done.succeed(results)

            return cb

        for i, g in enumerate(gens):
            env.process(g).add_callback(on_finish(i))
        return done

    def open(self) -> SimEvent:
        return self._all([s.g_open() for s in self.shards])

    def publish(self, version: int) -> SimEvent:
        return self._all([s.g_publish(version) for s in self.shards])

    def unpublish(self) -> SimEvent:
        return self._all([s.g_unpublish() for s in self.shards])

    def replicate(self, spec="latest", *, stall: bool = True) -> SimEvent:
        return self._all([s.g_replicate(spec, stall=stall) for s in self.shards])

    def update(self, spec="latest", *, stall: bool = True) -> SimEvent:
        return self._all([s.g_update(spec, stall=stall) for s in self.shards])
