"""TensorHub client library: the Table-2 API (4.2).

``TensorHubClient`` is the per-process endpoint; ``ShardHandle`` is the
per-shard handle returned by :func:`TensorHubClient.open`. This is the
*real* (threaded, blocking) implementation: every handle's weights live
on the client's device (the card by default), and pulls move, encode and
verify them there.

Blocking semantics are layered on the non-blocking server: a
``threading.Condition`` guards every server call, and the server's watcher
hook wakes waiters after each state mutation.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Set

import torch

from repro_torch.core import server as server_lib
from repro_torch.core.errors import (
    ChecksumError,
    ConsistencyError,
    ServerUnavailableError,
    StaleHandleError,
    TensorHubError,
    VersionUnavailableError,
)
from repro_torch.core.meta import DEFAULT_CHUNK_BYTES, DEFAULT_WINDOW, WorkerInfo
from repro_torch.core.server import Assignment, ReferenceServer, SourceSlice, offload_name
from repro_torch.obs import telemetry as obs
from repro_torch.resharding import rowgrid
from repro_torch.transfer import checksum as checksum_lib
from repro_torch.transfer import codec as codec_lib
from repro_torch.transfer.engine import (
    LocalTransport,
    TransportError,
    WorkerRegistry,
    WorkerStore,
    resolve_device,
)
from repro_torch.transfer.faults import DEFAULT_RETRY_POLICY, RetryPolicy

_POLL = 0.02  # condition re-check period (seconds)

#: op-id namespaces for post-failover re-assertion (keyed by version so
#: every shard of a group derives the same id without coordination);
#: disjoint from the per-handle sequences (0.. and 1_000_000..)
_REASSERT_PUBLISH_BASE = 2_000_000
_REASSERT_BEGIN_BASE = 3_000_000
_REESTABLISH_BASE = 4_000_000  # distinct from the reassert begin: the two
# can target the same version with different op kinds (begin_update vs the
# parked begin_replicate), and one op id must never carry both


class _SourceLost(Exception):
    """Internal: the assigned source failed us mid-pull; report with the
    carried evidence class ("fatal" | "transient" | "corrupt"), re-route
    and resume. Fatal evidence evicts the source (fail-stop, 4.5);
    transient/corrupt evidence accumulates quarantine strikes instead."""

    def __init__(self, source: str, evidence: str = "fatal") -> None:
        super().__init__(source)
        self.source = source
        self.evidence = evidence


#: one data-plane fetch: a whole transfer unit, or a byte sub-range of
#: one; ``owner`` is the plan slice the server assigned it to (load hint)
_PullTask = collections.namedtuple("_PullTask", "unit offset nbytes owner")


def _link_class(source: str, transport: str) -> str:
    """Link class for byte accounting, aligned with the simulator's link
    tags: WAN-negotiated TCP slices ride the VPC gateway, offload twins
    the PCIe bus, everything else the RDMA fabric."""
    if source.endswith("@offload"):
        return "pcie"
    return "vpc_up" if transport == "tcp" else "rdma"


#: re-exported for callers that imported it from here historically
from repro_torch.core.meta import dtype_from_str  # noqa: E402


class TensorHubClient:
    """Process-wide client endpoint: server + transport + registry."""

    def __init__(
        self,
        server: ReferenceServer,
        *,
        registry: Optional[WorkerRegistry] = None,
        transport: Optional[LocalTransport] = None,
        clock: Callable[[], float] = time.monotonic,
        window: int = DEFAULT_WINDOW,
        chunk_bytes: Optional[int] = DEFAULT_CHUNK_BYTES,
        failover_timeout: float = 30.0,
        recorder: Optional[obs.Recorder] = None,
        retry_policy: Optional[RetryPolicy] = None,
        faults=None,
        device="cuda",
    ) -> None:
        #: where every handle's registered weights live and every pull
        #: lands: the card by default; without one this raises rather
        #: than quietly running on the host (pass device="cpu" for that)
        self.device = resolve_device(device)
        self.server = server
        self.registry = registry or WorkerRegistry()
        #: telemetry recorder shared with the transport; disabled by
        #: default so the hot paths stay allocation-free
        self.recorder = obs.DISABLED if recorder is None else recorder
        #: gray-failure self-healing knobs (per-read deadline, bounded
        #: retries, hedged-read straggler threshold) shared by every handle
        self.retry_policy = (
            DEFAULT_RETRY_POLICY if retry_policy is None else retry_policy
        )
        #: ``faults`` (a ThreadedFaultInjector) only applies to the
        #: default transport built here; an explicitly passed transport
        #: carries its own injector (or none)
        self.transport = transport or LocalTransport(
            self.registry, recorder=self.recorder, faults=faults
        )
        self.clock = clock
        #: data-plane knobs inherited by every handle opened through this
        #: client: concurrent unit fetches per shard, and the sub-unit
        #: chunk threshold (None disables chunking). window=1 + no
        #: chunking reproduces the sequential one-fetch-at-a-time loop.
        self.window = max(1, window)
        self.chunk_bytes = (
            int(chunk_bytes) if chunk_bytes and chunk_bytes > 0 else None
        )
        #: how long a blocked server call waits for failover() to install
        #: a recovered server after a controller crash
        self.failover_timeout = failover_timeout
        self._handles: List["ShardHandle"] = []
        self._cv = threading.Condition(threading.RLock())
        server.add_watcher(self._wake)

    # -- controller failover ---------------------------------------------------

    def call(self, method: str, *args, **kwargs):
        """Invoke a server method, riding out a controller crash.

        Caller must hold ``self._cv``. On :class:`ServerUnavailableError`
        the call parks until :meth:`failover` installs a recovered server,
        then retries there. Retrying across the crash is safe because
        every control-plane op is idempotent under re-delivery (group ops
        return their cached result; progress reports are max-based)."""
        rec = self.recorder
        if not rec.enabled:
            while True:
                srv = self.server
                try:
                    return getattr(srv, method)(*args, **kwargs)
                except ServerUnavailableError:
                    self._await_failover(srv)
        t0 = rec.clock()
        try:
            while True:
                srv = self.server
                try:
                    return getattr(srv, method)(*args, **kwargs)
                except ServerUnavailableError:
                    self._await_failover(srv)
        finally:
            rec.counter_add(obs.CTR_CONTROL, rec.clock() - t0)

    def _wait(self, timeout: float = _POLL) -> None:
        """Park on the client condition; accounted as plan-wait stall."""
        rec = self.recorder
        if not rec.enabled:
            self._cv.wait(timeout)
            return
        t0 = rec.clock()
        self._cv.wait(timeout)
        rec.counter_add(obs.CTR_PLAN_WAIT, rec.clock() - t0)

    def _await_failover(self, crashed: ReferenceServer) -> None:
        deadline = time.monotonic() + self.failover_timeout
        while self.server is crashed:
            if time.monotonic() > deadline:
                raise ServerUnavailableError(
                    "controller down and no failover server installed "
                    f"within {self.failover_timeout}s"
                )
            # plain cv wait: call() is already timing this parked period
            # as control-plane stall, so don't also count it as plan-wait
            self._cv.wait(_POLL)

    def failover(self, new_server: ReferenceServer) -> None:
        """Switch every handle to a recovered/standby server (built by
        ``repro_torch.core.failover.recover``) after the primary crashed.

        Handles re-assert whatever durable state the recovered server may
        have lost from the unflushed log tail — their registration, their
        published version, and their in-flight replicate/update op — and
        blocked calls then resume transparently; in-flight pulls pick up
        the re-issued plan through the existing epoch machinery and
        resume from their completed prefix.

        Re-assertion is two-phase across ALL handles: every handle first
        re-establishes its steady state (open/register/publish), and only
        then are in-flight begin ops re-issued. Ordering matters — a
        reader's re-issued ``begin_update("latest")`` must not resolve
        against a server whose publisher has not re-published yet (it
        would come back not-updated and strand the mid-pull threads)."""
        with self._cv:
            if new_server is self.server:
                return
            self.server = new_server
            new_server.add_watcher(self._wake)
            for phase in ("steady", "inflight"):
                for h in list(self._handles):
                    try:
                        h.reassert(phase)
                    except TensorHubError as e:  # pragma: no cover - diagnostics
                        import logging

                        logging.getLogger(__name__).warning(
                            "%s: reassert (%s) after failover failed: %s",
                            h.worker.worker_id,
                            phase,
                            e,
                        )
            self._cv.notify_all()

    def _wake(self) -> None:
        # The watcher fires while the server mutation holds our lock (all
        # server calls go through `self._cv`). Out-of-band mutations (test
        # harnesses injecting failures) are tolerated: waiters re-poll on
        # their own timeout.
        try:
            self._cv.notify_all()
        except RuntimeError:
            pass

    def open(
        self,
        model_name: str,
        replica_name: str,
        num_shards: int,
        shard_idx: int,
        *,
        retain: Optional[object] = None,
        datacenter: str = "dc0",
        node: Optional[str] = None,
        is_spot: bool = False,
        offload_seeding: bool = False,
        with_checksums: bool = True,
        device_repack: bool = False,
        window: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
    ) -> "ShardHandle":
        worker = WorkerInfo(
            worker_id=f"{replica_name}/shard{shard_idx}",
            node=node or f"{datacenter}/{replica_name}",
            datacenter=datacenter,
            is_spot=is_spot,
        )
        handle = ShardHandle(
            client=self,
            model=model_name,
            replica=replica_name,
            shard_idx=shard_idx,
            num_shards=num_shards,
            worker=worker,
            retain=retain,
            offload_seeding=offload_seeding,
            with_checksums=with_checksums,
            device_repack=device_repack,
            window=self.window if window is None else max(1, window),
            chunk_bytes=self.chunk_bytes if chunk_bytes is None else (
                int(chunk_bytes) if chunk_bytes and chunk_bytes > 0 else None
            ),
        )
        with self._cv:
            # open + handle registration under ONE cv hold: a failover
            # interleaved between them would miss the handle in the
            # reassert sweep while its open record sat in the lost tail
            self.call(
                "open",
                model_name,
                replica_name,
                num_shards,
                shard_idx,
                worker=worker,
                retain=retain,
            )
            self._handles.append(handle)
        return handle

    # -- background heartbeats --------------------------------------------------

    def start_heartbeats(
        self, interval: float, *, clock: Optional[Callable[[], float]] = None
    ) -> None:
        """Heartbeat every open handle on a daemon thread.

        The in-process tests drive heartbeats explicitly with virtual
        timestamps; a networked worker wants them ambient, on wall-clock
        time (``time.time`` by default — shared across processes, so a
        restarted controller's expiry ticks compare against the same
        axis). An evicted handle's ``StaleHandleError`` is swallowed:
        eviction is the *server's* verdict and the worker learns it
        through its event poll, not by crashing the heartbeat loop."""
        if getattr(self, "_hb_thread", None) is not None:
            return
        hb_clock = time.time if clock is None else clock
        self._hb_stop = threading.Event()

        def loop() -> None:
            while not self._hb_stop.wait(interval):
                for h in list(self._handles):
                    try:
                        h.heartbeat(hb_clock())
                    except TensorHubError:
                        continue

        self._hb_thread = threading.Thread(
            target=loop, name="tensorhub-heartbeats", daemon=True
        )
        self._hb_thread.start()

    def stop_heartbeats(self) -> None:
        if getattr(self, "_hb_thread", None) is None:
            return
        self._hb_stop.set()
        self._hb_thread.join(timeout=2.0)
        self._hb_thread = None


class ShardHandle:
    """Handle for one shard of one replica (Table 2)."""

    def __init__(
        self,
        *,
        client: TensorHubClient,
        model: str,
        replica: str,
        shard_idx: int,
        num_shards: int,
        worker: WorkerInfo,
        offload_seeding: bool,
        with_checksums: bool,
        retain: Optional[object] = None,
        device_repack: bool = False,
        window: int = DEFAULT_WINDOW,
        chunk_bytes: Optional[int] = DEFAULT_CHUNK_BYTES,
    ) -> None:
        self.client = client
        self.model = model
        self.replica = replica
        self.shard_idx = shard_idx
        self.num_shards = num_shards
        self.worker = worker
        self.retain = retain
        self.offload_seeding = offload_seeding
        self.with_checksums = with_checksums
        #: windowed data plane: concurrent unit fetches for this shard's
        #: pulls, and the sub-unit chunk threshold (None = off)
        self.window = window
        self.chunk_bytes = chunk_bytes
        #: kept for API parity with the JAX package only: a resharded pull
        #: repacks on its destination store's device, through the gather
        #: and fused dequant+gather kernels on the card (the plain versions
        #: run only on the CPU), whatever this flag says
        self.device_repack = device_repack
        self.store = WorkerStore(worker.worker_id, device=client.device)
        self.current_version: Optional[int] = None
        #: lifetime count of striped interval reads this handle completed
        #: across all reshard pulls (per-interval progress; the
        #: server-visible counter advances in completed destination units)
        self.intervals_pulled = 0
        self._op_seq = 0
        self._off_op_seq = 1_000_000  # twin namespace, disjoint from main ops
        self._offload_stores: Dict[int, WorkerStore] = {}
        self._seed_threads: Dict[int, threading.Thread] = {}
        self._closed = False
        #: failover re-assertion state: whether register() ran, and the
        #: in-flight blocking op — (kind, spec, op_id) — if a replicate or
        #: update is mid-pull when the controller dies
        self._registered = False
        self._inflight: Optional[tuple] = None
        #: (version, op_id) of our last publish(): a post-failover
        #: re-publish re-joins the same group op, so shards that did make
        #: it into the durable log and shards that did not converge on one
        #: transaction
        self._publish_op: Optional[tuple] = None

    # -- helpers ---------------------------------------------------------------

    @property
    def _cv(self) -> threading.Condition:
        return self.client._cv

    @property
    def _server(self) -> ReferenceServer:
        return self.client.server

    def _next_op(self) -> int:
        op = self._op_seq
        self._op_seq += 1
        return op

    def _next_off_op(self) -> int:
        op = self._off_op_seq
        self._off_op_seq += 1
        return op

    def _scall(self, method: str, *args, **kwargs):
        """Server call with controller-failover retry (cv must be held)."""
        return self.client.call(method, *args, **kwargs)

    # -- controller failover (see TensorHubClient.failover) ---------------------

    def reassert(self, phase: str = "steady") -> None:
        """Re-establish this shard's control-plane state on a freshly
        recovered server that may have lost an unflushed suffix of the op
        log. Called under the client cv by ``TensorHubClient.failover``,
        once per phase: ``"steady"`` (open/register/publish) runs for
        every handle before any ``"inflight"`` begin re-issue, so a
        reader's ``begin_update("latest")`` never resolves against a
        server whose publisher has not re-published yet.

        Everything re-issued here is idempotent against a server that did
        NOT lose the corresponding records: re-opening an open shard is
        absorbed, register() is a set-add, and a re-delivered group op
        returns its cached result. In-flight pull threads then self-heal:
        the re-issued begin installs fresh in-progress state, their next
        epoch check triggers a re-plan, and max-based progress reports
        re-assert the completed prefix."""
        if self._closed:
            return
        srv = self.client.server
        if phase == "steady":
            try:
                srv.open(
                    self.model,
                    self.replica,
                    self.num_shards,
                    self.shard_idx,
                    worker=self.worker,
                    retain=self.retain,
                )
            except ConsistencyError:
                pass  # this shard is already open on the recovered server
            if self._registered:
                srv.register(self.model, self.replica, self.shard_idx)
            # if the recovered server lost our publish (all shards, or
            # just this one — another shard's record, or its reassert,
            # may already have re-installed the version), vouch for the
            # registered bytes again (fresh manifest — buffers are
            # immutable while published, so it is identical)
            if (
                self._inflight is None
                and self.current_version is not None
                and self._shard_publish_lost(srv)
            ):
                v = self.current_version
                if self._publish_op is not None and self._publish_op[0] == v:
                    # re-join the original publish group op, so durable
                    # and lost shards converge on one transaction
                    op = self._publish_op[1]
                else:
                    op = _REASSERT_PUBLISH_BASE + v
                srv.publish(
                    self.model,
                    self.replica,
                    self.shard_idx,
                    v,
                    self.store.build_manifest(with_checksums=self.with_checksums),
                    op_id=op,
                )
            return
        infl = self._inflight
        if infl is None:
            return
        kind, spec, op, pinned = infl
        if pinned is not None:
            # mid-pull of a KNOWN version: re-issue pinned to it under a
            # version-derived op id — a relative spec like "latest" may
            # resolve differently on the recovered server (a newer
            # publish survived in the log), and installing in-progress
            # state for any other version would strand the pull threads.
            # Against a server that retained the original state this
            # degenerates to a no-op ("already current" / mutability
            # rejection on a fresh op id).
            op2 = _REASSERT_BEGIN_BASE + pinned
            try:
                if kind == "replicate":
                    srv.begin_replicate(
                        self.model, self.replica, self.shard_idx, pinned, op_id=op2
                    )
                else:
                    srv.begin_update(
                        self.model,
                        self.replica,
                        self.shard_idx,
                        pinned,
                        op_id=op2,
                        offload_seeding=self.offload_seeding,
                    )
            except TensorHubError:
                pass  # state (partially) present; pulls self-heal via epochs
            return
        # begin not yet answered: re-issue the original op verbatim —
        # cached result if the server kept the txn, fresh (identical)
        # execution if the log tail lost it
        if kind == "replicate":
            srv.begin_replicate(
                self.model, self.replica, self.shard_idx, spec, op_id=op
            )
        else:
            srv.begin_update(
                self.model,
                self.replica,
                self.shard_idx,
                spec,
                op_id=op,
                offload_seeding=self.offload_seeding,
            )

    def _reestablish(self, version: int, dest_name: str) -> None:
        """Last-resort recovery for a pull whose in-progress state is
        missing from the (recovered) server and whose re-issued begin
        could not restore it — e.g. the target version's publisher lives
        in ANOTHER client process that has not failed over yet, so
        reassert ordering cannot help. Park a replicate for the absolute
        version we were pulling: ``_service_pending`` assigns it the
        moment a source (re)appears, and the waiting pull threads resume
        from their completed prefix. cv must be held."""
        if dest_name != self.replica or self._inflight is None:
            return
        try:
            self._scall(
                "begin_replicate",
                self.model,
                self.replica,
                self.shard_idx,
                version,
                op_id=_REESTABLISH_BASE + version,
            )
        except TensorHubError:
            pass  # state partially present (e.g. old version still held)

    def _shard_publish_lost(self, srv: ReferenceServer) -> bool:
        """Whether the recovered server is missing THIS shard's record of
        our published version (whole-version loss or a partial group)."""
        v = self.current_version
        if srv.replica_version(self.model, self.replica) != v:
            return True
        try:
            return srv.shard_progress(self.model, self.replica, v, self.shard_idx) == 0
        except TensorHubError:
            return True

    # -- Table 2: register / unregister -----------------------------------------

    def register(
        self,
        named_tensors: Mapping[str, torch.Tensor],
        *,
        layout: Optional[Mapping[str, tuple]] = None,
    ) -> None:
        """Register weight buffers, held in place on the client's device.
        ``layout`` maps tensor name to
        ``(global_shape, offset)`` — the layout descriptor that makes this
        shard a valid source/destination for cross-layout resharding
        (see ``repro_torch.resharding``; ``tp_shard`` builds it)."""
        self.store.register(named_tensors, layout=layout)
        self.client.registry.add(self.replica, self.shard_idx, self.store)
        with self._cv:
            self._scall("register", self.model, self.replica, self.shard_idx)
            self._registered = True

    def unregister(self) -> None:
        with self._cv:
            self._scall("unregister", self.model, self.replica, self.shard_idx)
            self._registered = False
        self.client.registry.remove(self.replica, self.shard_idx)
        self.store.unregister()

    # -- Table 2: publish / unpublish --------------------------------------------

    def publish(self, version: int) -> None:
        rec = self.client.recorder
        sp = (
            rec.span("publish", track=self.worker.worker_id, version=version)
            if rec.enabled
            else None
        )
        try:
            # publishing vouches for every registered byte: lift any
            # watermark a previously aborted pull left on the store
            self.store.serving_prefix = None
            manifest = self.store.build_manifest(with_checksums=self.with_checksums)
            op = self._next_op()
            with self._cv:
                self._scall(
                    "publish",
                    self.model, self.replica, self.shard_idx, version, manifest, op_id=op
                )
            self.current_version = version
            self._publish_op = (version, op)
        finally:
            if sp is not None:
                sp.end()

    def unpublish(self) -> None:
        # snapshot the retiring version as the delta base BEFORE telling
        # the server: once unpublish lands, the server may negotiate
        # residuals against this replica's prior version, and the
        # snapshot must already exist when the first delta read arrives
        v = self.current_version
        if v is not None:
            self.store.snapshot_base(v)
        op = self._next_op()
        with self._cv:
            res = self._scall(
                "unpublish", self.model, self.replica, self.shard_idx, op_id=op
            )
        if res.offload_required:
            assert res.offload_version is not None
            self._do_retention_offload(res.offload_version)
        self._wait_drained()
        self.current_version = None
        self.process_events()

    def _do_retention_offload(self, version: int) -> None:
        """Retention protocol (3.3): copy this shard to host memory and
        publish the copy before the GPU buffers may be reused."""
        off_store = WorkerStore(f"{self.worker.worker_id}@offload", device="cpu")
        self.store.snapshot_to(off_store)
        self._offload_stores[version] = off_store
        self.client.registry.add(offload_name(self.replica), self.shard_idx, off_store)
        manifest = off_store.build_manifest(with_checksums=self.with_checksums)
        op = self._next_op()
        with self._cv:
            self._scall(
                "publish_offload",
                self.model, self.replica, self.shard_idx, version, manifest, op_id=op
            )

    def _wait_drained(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._scall("finish_unpublish", self.model, self.replica):
                if deadline is not None and time.monotonic() > deadline:
                    raise TensorHubError(f"{self.replica}: drain timed out")
                self.client._wait(_POLL)

    # -- Table 2: replicate / update ----------------------------------------------

    def replicate(self, version: object = "latest", *, timeout: Optional[float] = None) -> int:
        """Materialize ``version`` into the registered tensors; blocks until
        the version exists. Returns the absolute version fetched."""
        op = self._next_op()
        deadline = None if timeout is None else time.monotonic() + timeout
        rec = self.client.recorder
        sp = (
            rec.span("replicate", track=self.worker.worker_id)
            if rec.enabled
            else None
        )
        try:
            with self._cv:
                self._inflight = ("replicate", version, op, None)
                assignment = self._scall(
                    "begin_replicate",
                    self.model, self.replica, self.shard_idx, version, op_id=op
                )
                while assignment is None:
                    if deadline is not None and time.monotonic() > deadline:
                        raise VersionUnavailableError(
                            f"{self.model} {version!r}: not published within timeout"
                        )
                    self.client._wait(_POLL)
                    assignment = self._scall("redeem", self.model, self.replica, op_id=op)
                # pin the in-flight op to the RESOLVED version: "latest"
                # may resolve differently on a recovered server, and a
                # reassert must restore the version this pull is pulling
                self._inflight = ("replicate", version, op, assignment.version)
            self._note_assignment(assignment)
            self._pull(assignment, op_id=op, dest_name=self.replica, dest_store=self.store)
            self.current_version = assignment.version
        finally:
            with self._cv:
                self._inflight = None
            if sp is not None:
                sp.end()
        self.process_events()
        return assignment.version

    def update(self, version: object = "latest") -> bool:
        """Atomically switch to a newer version if available (Table 2)."""
        prev = self.current_version
        op = self._next_op()
        rec = self.client.recorder
        sp = None
        try:
            with self._cv:
                self._inflight = ("update", version, op, None)
                d = self._scall(
                    "begin_update",
                    self.model,
                    self.replica,
                    self.shard_idx,
                    version,
                    op_id=op,
                    offload_seeding=self.offload_seeding,
                )
                if d.updated and d.version is not None:
                    # pin to the resolved version (see replicate())
                    self._inflight = ("update", version, op, d.version)
            if d.seed_started and d.seed_version is not None:
                self._spawn_seed_pull(d.seed_version)
            if not d.updated:
                self.process_events()
                return False
            if rec.enabled:
                sp = rec.span("update", track=self.worker.worker_id, version=d.version)
            if d.offload_required and d.offload_version is not None:
                self._do_retention_offload(d.offload_version)
            self._wait_drained()
            # the buffers still hold the retiring version: snapshot them
            # as the delta base (this replica may later SERVE residuals
            # to a peer updating from the same prior version; the pull
            # below also decodes incoming residuals against these bytes,
            # still live in the buffers until each unit is overwritten)
            if prev is not None:
                self.store.snapshot_base(prev)
            assert d.assignment is not None
            self._note_assignment(d.assignment)
            self._pull(d.assignment, op_id=op, dest_name=self.replica, dest_store=self.store)
            self.current_version = d.version
        finally:
            with self._cv:
                self._inflight = None
            if sp is not None:
                sp.end()
        self.process_events()
        return True

    def _note_assignment(self, assignment: Assignment) -> None:
        """Record an assignment/epoch event on this shard's timeline."""
        rec = self.client.recorder
        if not rec.enabled:
            return
        rec.event(
            "assignment",
            track=self.worker.worker_id,
            version=assignment.version,
            epoch=assignment.epoch,
            sources=[s.source for s in assignment.sources],
            codec=assignment.codec,
        )

    # -- Table 2: list / wait / close ------------------------------------------------

    def list(self) -> Dict[int, set]:
        with self._cv:
            return self._scall("list_versions", self.model)

    def wait(self, predicate: Callable[[Dict[int, set]], bool], *, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not predicate(self._scall("list_versions", self.model)):
                if deadline is not None and time.monotonic() > deadline:
                    raise TensorHubError("wait(): predicate not satisfied within timeout")
                self.client._wait(_POLL)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for t in self._seed_threads.values():
            t.join(timeout=5.0)
        try:
            if self.current_version is not None:
                self.unpublish()
        except ServerUnavailableError:
            raise  # dead controller, not a dead source/handle
        except (StaleHandleError, TensorHubError):
            pass
        with self._cv:
            self._scall("close", self.model, self.replica, self.shard_idx)
            if self in self.client._handles:
                self.client._handles.remove(self)
        self.client.registry.remove(self.replica, self.shard_idx)
        self.client.registry.remove(offload_name(self.replica), self.shard_idx)

    # -- housekeeping -----------------------------------------------------------------

    def heartbeat(self, now: Optional[float] = None) -> None:
        with self._cv:
            self._scall(
                "heartbeat",
                self.model, self.replica, self.shard_idx,
                self.client.clock() if now is None else now,
            )

    def process_events(self) -> None:
        """Drain server events: free released offload buffers (3.3)."""
        with self._cv:
            events = self._scall("poll_events", self.worker.worker_id)
        for ev in events:
            if ev.kind == "offload_release" and ev.version is not None:
                store = self._offload_stores.pop(ev.version, None)
                if store is not None:
                    store.unregister()
                if not self._offload_stores:
                    self.client.registry.remove(offload_name(self.replica), self.shard_idx)

    # -- data plane ---------------------------------------------------------------------

    def _wait_src_manifest(
        self, version: int, source: str, shard_idx: Optional[int] = None
    ):
        """Wait for the assigned source replica's manifest for one of its
        shards. Resolution is by *replica* (falling back to its count
        family), so a same-count source sharded along different axes
        cannot be mistaken for our own layout."""
        idx = self.shard_idx if shard_idx is None else shard_idx
        with self._cv:
            while True:
                m = self._scall("replica_manifest", self.model, version, source, idx)
                if m is not None:
                    return m
                try:  # liveness: don't wait forever on an evicted source
                    self._scall("shard_progress", self.model, source, version, idx)
                except ServerUnavailableError:
                    raise  # dead controller, not a dead source/handle
                except (StaleHandleError, TensorHubError):
                    raise _SourceLost(source)
                self.client._wait(_POLL)

    def _pull(
        self,
        assignment: Assignment,
        *,
        op_id: int,
        dest_name: str,
        dest_store: WorkerStore,
        twin: bool = False,
    ) -> None:
        """The replication loop (4.3.3): repeatedly read the source's
        progress counter, fetch the available prefix, advance our own
        counter; re-route on source failure (4.5).

        Same-layout sources serve whole transfer units shard-to-shard;
        a source with a different shard count is served by the reshard
        path (striped interval reads + repack). Progress counts completed
        *destination* units in both cases, so a re-route mid-transfer may
        switch pull modes and still resume from the same counter — the
        replacement source can have yet another layout (re-planning).

        ``complete_replicate`` gets its *own* op id, allocated here — the
        allocation point is the same in every shard's program order (SPMD),
        so the group op keys stay aligned without ever reusing the begin
        op's id (whose transaction may still be open on slow shards).
        """
        del op_id  # the begin op id; completion uses a fresh one (below)
        version = assignment.version
        done = 0
        used_reshard = False
        # lossy wire codecs (cross-DC int8): decoded bytes diverge from
        # the publisher's, so readers chaining off us (or off anyone
        # downstream of the lossy hop — divergence propagates along raw
        # chains) must not verify against the publisher's manifest
        # checksums. The span loop registers a zero-checksum manifest the
        # moment a divergent plan is detected (mirroring the reshard
        # path), and the epilogue below upgrades it to our real checksums
        # once the bytes are final.
        pull_state = {"divergent": False, "rejects": {}}
        # swarm replication: while this pull is in flight the store serves
        # other readers exactly its completed prefix; the watermark is
        # advanced before every server progress report and lifted when the
        # pull completes (see WorkerStore.serving_prefix).
        dest_store.serving_prefix = 0
        reshard_rejects: Dict[int, int] = {}  # persists across re-plans
        while True:
            # the server-side counter is authoritative (max-based): a span
            # that advanced it before the source died resumes from there,
            # not from this attempt's stale local count
            with self._cv:
                try:
                    done = max(
                        done,
                        self._scall(
                            "shard_progress",
                            self.model, dest_name, version, self.shard_idx,
                        ),
                    )
                except ServerUnavailableError:
                    raise  # dead controller, not a dead source/handle
                except (StaleHandleError, TensorHubError):
                    pass  # no in-progress state yet (first span)
            if dest_store.serving_prefix is not None:
                dest_store.serving_prefix = max(dest_store.serving_prefix, done)
            try:
                reshard = assignment.resharded
                src_manifest = None
                if not reshard:
                    # equal shard counts are necessary but not sufficient:
                    # a same-count source sliced along other axes must go
                    # through the reshard path too, or unit copies would
                    # silently scramble weights
                    src_manifest = self._wait_src_manifest(version, assignment.source)
                    reshard = not src_manifest.same_layout(
                        dest_store.build_manifest(with_checksums=False)
                    )
                if reshard:
                    used_reshard = True
                    done = self._pull_resharded_span(
                        assignment, dest_name, dest_store, done,
                        rejects=reshard_rejects,
                    )
                else:
                    done = self._pull_units_span(
                        assignment, dest_name, dest_store, done, src_manifest,
                        pull_state,
                    )
                break
            except _SourceLost as e:
                assignment = self._handle_source_failure(
                    dest_name, e.source, e.evidence
                )
        dest_store.serving_prefix = None  # fully replicated: unrestricted
        if (used_reshard or pull_state["divergent"]) and self.with_checksums:
            # our layout family was registered with zero checksums (pre-pull
            # buffers / lossy-decoded bytes mid-flight); now that the bytes
            # are final, upgrade it so readers chaining off us get
            # end-to-end verification back
            rec = self.client.recorder
            t0 = rec.clock() if rec.enabled else 0.0
            manifest = dest_store.build_manifest(with_checksums=True)
            if rec.enabled:
                # checksumming the whole shard is verify work — without it
                # the stall components would not tile the pull wall time
                rec.counter_add(obs.CTR_VERIFY, rec.clock() - t0)
                rec.event("manifest_upgrade", track=dest_name, version=version)
            with self._cv:
                self._scall(
                    "put_manifest",
                    self.model,
                    dest_name,
                    self.shard_idx,
                    version,
                    manifest,
                )
        complete_op = self._next_off_op() if twin else self._next_op()
        with self._cv:
            self._scall(
                "complete_replicate",
                self.model, dest_name, self.shard_idx, version, op_id=complete_op
            )

    def _pull_units_span(
        self,
        assignment: Assignment,
        dest_name: str,
        dest_store: WorkerStore,
        done: int,
        manifest,
        pull_state: Optional[dict] = None,
    ) -> int:
        """Same-layout pull: whole transfer units (or byte-range chunks of
        them), shard i <- shard i, against the source replicas' manifests
        (schema + checksums). Multi-source assignments partition the unit
        list across replicas; the windowed executor keeps up to ``window``
        fetches in flight and advances the progress counter strictly over
        the completed prefix."""
        version = assignment.version
        units = manifest.units
        completed: Set[int] = set()
        if pull_state is None:
            pull_state = {"divergent": False}
        # per-destination-unit checksum-reject counts: persists across
        # re-plans so a genuinely corrupt unit (every source serves bad
        # bytes) aborts after retry_limit rejects instead of looping
        rejects: Dict[int, int] = pull_state.setdefault("rejects", {})
        while done < len(units):
            slices = assignment.slices(len(units))
            if not pull_state["divergent"] and self._divergent_pull(
                assignment, manifest, version
            ):
                # Our bytes will diverge from the count-family (publisher)
                # manifest — either a lossy slice decodes in this plan, or
                # we are chaining off a replica whose own bytes already
                # diverged (its manifest checksums differ from the
                # family's). Register a zero-checksum manifest for
                # ourselves BEFORE serving any prefix so chained readers
                # skip publish-time verification against bytes we don't
                # hold; the pull epilogue upgrades it to our real
                # (decoded-byte) checksums.
                pull_state["divergent"] = True
                with self._cv:
                    self._scall(
                        "put_manifest",
                        self.model,
                        dest_name,
                        self.shard_idx,
                        version,
                        dest_store.build_manifest(with_checksums=False),
                    )
            if self.window <= 1 and self.chunk_bytes is None and len(slices) == 1:
                return self._pull_units_seq(
                    assignment, dest_name, dest_store, done, manifest, rejects
                )
            completed -= set(range(done))
            slices = self._validated_slices(slices, version, manifest)
            outcome, done = self._pull_units_windowed(
                assignment, slices, dest_name, dest_store, done, manifest,
                completed, rejects,
            )
            if outcome == "replan":
                with self._cv:
                    new = self._scall("get_assignment", self.model, dest_name)
                    if new is None:
                        # in-progress state vanished: a controller failover
                        # lost it and this client's reassert could not
                        # restore it (e.g. the publisher lives in another
                        # process that has not failed over yet). Park a
                        # replicate for the absolute version and wait for
                        # a source to (re)appear.
                        self._reestablish(version, dest_name)
                        deadline = (
                            time.monotonic() + self.client.failover_timeout
                        )
                        while new is None:
                            if time.monotonic() > deadline:
                                raise StaleHandleError(
                                    f"{dest_name}: in-progress state for "
                                    f"v{version} not re-established after "
                                    "controller failover"
                                )
                            self.client._wait(_POLL)
                            new = self._scall(
                                "get_assignment", self.model, dest_name
                            )
                if new is not None and not new.resharded:
                    assignment = new
                # a resharded refetch loops and retries on the same
                # plan; a dead source surfaces as _SourceLost upstream
        return done

    def _divergent_pull(self, assignment: Assignment, manifest, version: int) -> bool:
        """Whether this pull will leave us with bytes whose checksums
        differ from the count-family (publisher) manifest — readers
        resolving us through the family fallback would then mis-verify.
        True when any negotiated codec in the plan is lossy, or when the
        source manifest we verify against already carries non-family
        checksums (the source itself descends from a lossy transfer:
        divergence propagates down raw chains)."""
        if codec_lib.assignment_lossy(assignment):
            return True
        with self._cv:
            fam = self._scall(
                "manifest",
                self.model,
                version,
                self.shard_idx,
                num_shards=self.num_shards,
            )
        return fam is not None and tuple(fam.checksums) != tuple(manifest.checksums)

    def _validated_slices(
        self, slices: List[SourceSlice], version: int, manifest
    ) -> List[SourceSlice]:
        """Unit pulls are interchangeable only between byte-identical
        layouts; drop any sibling source whose manifest diverges from the
        primary's (the server filters too — this is the client-side
        guard). The primary is never dropped.

        Layout identity alone is not enough: the windowed executor
        verifies every unit against the *primary's* checksums, so a
        sibling must also hold the same bytes. A replica whose manifest
        carries different checksums (it descends from a lossy int8 hop
        while the primary holds publisher bytes, or vice versa) would
        fail verification — or worse, silently mix byte provenance with
        checksums off — so it is dropped from the plan."""
        if len(slices) <= 1:
            return slices
        kept = [slices[0]]
        for sl in slices[1:]:
            m = self._wait_src_manifest(version, sl.source)
            if m.same_layout(manifest) and tuple(m.checksums) == tuple(
                manifest.checksums
            ):
                kept.append(sl)
        return kept

    def _pull_units_seq(
        self,
        assignment: Assignment,
        dest_name: str,
        dest_store: WorkerStore,
        done: int,
        manifest,
        rejects: Optional[Dict[int, int]] = None,
    ) -> int:
        """The pre-scheduler data plane: one whole-unit fetch at a time
        from a single source (window=1, chunking off)."""
        version = assignment.version
        units = manifest.units
        source = assignment.source
        codec = assignment.codec
        rec = self.client.recorder
        track = self.worker.worker_id
        lc = _link_class(source, assignment.transport)
        policy = self.client.retry_policy
        if rejects is None:
            rejects = {}
        while done < len(units):
            avail = self._await_source_progress(source, version, self.shard_idx, done)
            for i in range(done, avail):
                sp = None
                if rec.enabled:
                    t0 = rec.clock()
                    sp = rec.span(
                        "pull_unit", track=track, source=source, codec=codec,
                        unit=units[i].name, bytes=units[i].nbytes, link_class=lc,
                    )
                try:
                    self._retry_transient(
                        lambda i=i: self.client.transport.pull_unit(
                            source, self.shard_idx, units[i],
                            manifest.checksums[i], dest_store, codec=codec,
                            link_class=lc, track=track,
                        ),
                        source,
                        unit=units[i].name,
                    )
                except TransportError as e:
                    if dest_store.failed:
                        # OUR store died (preemption): the write guard
                        # fired, not the source — blaming the source
                        # would evict a healthy replica cluster-wide
                        raise
                    raise _SourceLost(
                        source,
                        evidence="transient"
                        if getattr(e, "transient", False)
                        else "fatal",
                    )
                except (ChecksumError, codec_lib.CodecError):
                    # corrupt bytes from this source: report the evidence
                    # (the server quarantines it and re-plans) and resume
                    # from the prefix instead of aborting the pull. Bounded
                    # per unit: if every re-plan keeps rejecting the same
                    # unit, the data is genuinely bad — propagate. A
                    # CodecError is a torn/misframed wire frame — the
                    # decode-failure twin of a checksum mismatch; it routes
                    # through the same healing (StaleBaseError never
                    # reaches here: the transport resolves delta-base
                    # staleness internally, it is not source corruption).
                    rejects[i] = rejects.get(i, 0) + 1
                    if rejects[i] > policy.retry_limit:
                        raise
                    if rec.enabled:
                        rec.counter_add(obs.CTR_CORRUPT_REJECTS, 1)
                        rec.event(
                            "corrupt_reject", track=track, source=source,
                            unit=units[i].name,
                        )
                    raise _SourceLost(source, evidence="corrupt")
                finally:
                    if sp is not None:
                        sp.end()
                        rec.counter_add(obs.CTR_WIRE, rec.clock() - t0)
                done += 1
                dest_store.serving_prefix = done  # before the server learns
                if rec.enabled:
                    rec.event("prefix_advance", track=track, done=done)
                with self._cv:
                    self._scall(
                        "update_progress",
                        self.model, dest_name, self.shard_idx, version, done,
                    )
        return done

    def _build_pull_tasks(
        self,
        slices: List[SourceSlice],
        manifest,
        done: int,
        completed: Set[int],
    ) -> List[_PullTask]:
        """Expand the plan's unit ranges into an ordered task list; units
        above the chunk threshold become byte-range tasks, owner-hinted
        round-robin across all sources (identical bytes everywhere, so a
        giant tensor can aggregate every source's bandwidth).

        With a non-raw codec in the plan, chunk boundaries are aligned up
        to the codec's row granularity so every chunk encodes exactly the
        rows the whole-unit encoding would — chunked giant units then
        reassemble bit-identically to an unchunked transfer."""
        units = manifest.units
        chunk = self.chunk_bytes
        codecs = [codec_lib.get_codec(sl.codec) for sl in slices]
        any_coded = any(c.name != "raw" for c in codecs)
        by_name = {t.name: t for t in manifest.tensors} if any_coded else {}
        owners: Dict[int, int] = {}
        for k, sl in enumerate(slices):
            for ui in range(max(sl.start_unit, done), min(sl.stop_unit, len(units))):
                owners.setdefault(ui, k)
        tasks: List[_PullTask] = []
        rr = 0
        for ui in range(done, len(units)):
            if ui in completed:
                continue
            k = owners.get(ui, 0)
            nbytes = units[ui].nbytes
            if chunk is not None and nbytes > chunk:
                n_parts = -(-nbytes // chunk)
                per = -(-nbytes // n_parts)
                if any_coded:
                    dtype = codec_lib.unit_wire_dtype(by_name, units[ui])
                    per = rowgrid.chunk_align(
                        per,
                        rowgrid.row_granularity(
                            [c.name for c in codecs], dtype
                        ),
                    )
                off = 0
                j = 0
                while off < nbytes:
                    step = min(per, nbytes - off)
                    tgt = (rr + j) % len(slices) if len(slices) > 1 else k
                    tasks.append(_PullTask(ui, off, step, tgt))
                    off += step
                    j += 1
                rr += j
            else:
                tasks.append(_PullTask(ui, 0, nbytes, k))
        return tasks

    def _pull_units_windowed(
        self,
        assignment: Assignment,
        slices: List[SourceSlice],
        dest_name: str,
        dest_store: WorkerStore,
        done: int,
        manifest,
        completed: Set[int],
        rejects: Optional[Dict[int, int]] = None,
    ):
        """Windowed multi-source executor: one worker thread per source
        slice, a shared semaphore capping in-flight fetches at ``window``,
        global in-order task claiming (a worker takes the lowest-indexed
        task its source's progress covers — keeps the prefix counter that
        gates downstream readers advancing at full rate), and whole-unit
        checksum verification after chunk reassembly.

        The span is *supervised*, not joined: a monitor thread watches
        per-task read deadlines and the assignment epoch, so a source
        that hangs mid-read (the gray failure a heartbeat never sees)
        gets reported and the span drains on the resulting re-plan
        instead of pinning the pull forever. Hung daemon workers are
        abandoned safely — every post-read write is gated on the span's
        stop flag and per-task completion claims."""
        version = assignment.version
        units = manifest.units
        tasks = self._build_pull_tasks(slices, manifest, done, completed)
        if not tasks:
            return "done", done
        remaining: Dict[int, int] = {}
        for t in tasks:
            remaining[t.unit] = remaining.get(t.unit, 0) + 1
        shared = {
            "lock": threading.Lock(),
            "sem": threading.Semaphore(self.window),
            "tasks": tasks,
            "claimed": [False] * len(tasks),
            "unclaimed": len(tasks),
            "scan": 0,
            "remaining": remaining,
            "staging": {},  # unit -> uint8 reassembly tensor
            "lossy_units": set(),  # units with any lossy-codec chunk
            "completed": completed,  # shared with caller: survives re-plans
            "done": done,
            "stop": None,  # None | "replan" | BaseException
            "epoch": assignment.epoch,
            # self-healing state --------------------------------------
            "rejects": rejects if rejects is not None else {},
            "taskdone": [False] * len(tasks),  # completion claims
            "ntaskdone": 0,
            "inflight": {},  # task idx -> (start_clock, source)
            "durations": [],  # completed read durations (hedge baseline)
            "hedged": set(),  # task idxs already duplicated once
            "done_ev": threading.Event(),
        }
        workers = [
            threading.Thread(
                target=self._span_worker,
                args=(sl, shared, dest_name, dest_store, manifest, version),
                daemon=True,
                name=f"{self.worker.worker_id}-pull-{sl.source}",
            )
            for sl in slices
        ]
        for w in workers:
            w.start()
        self._monitor_span(shared, dest_name, version)
        stop = shared["stop"]
        if isinstance(stop, BaseException):
            raise stop
        if stop == "replan":
            return "replan", shared["done"]
        return "done", shared["done"]

    def _span_stop(self, shared: dict, stop) -> None:
        with shared["lock"]:
            if shared["stop"] is None or (
                isinstance(stop, BaseException)
                and not isinstance(shared["stop"], BaseException)
            ):
                shared["stop"] = stop
        ev = shared.get("done_ev")
        if ev is not None:
            ev.set()

    def _monitor_span(self, shared: dict, dest_name: str, version: int) -> None:
        """Supervise a windowed span: enforce per-read deadlines and
        watch the assignment epoch so hung workers can't pin the span.

        A read in flight longer than ``retry_policy.fail_detect`` is
        *transient* evidence against its source — reported (rate-limited
        per source to one report per detection window) so the server
        strike-counts and, at the quarantine threshold, re-plans around
        it. The epoch bump then drains the span; the hung worker thread
        is abandoned (daemon, post-read writes stop-gated)."""
        ev: threading.Event = shared["done_ev"]
        tasks: List[_PullTask] = shared["tasks"]
        policy = self.client.retry_policy
        rec = self.client.recorder
        track = self.worker.worker_id
        last_report: Dict[str, float] = {}
        while not ev.wait(_POLL):
            now = self.client.clock()
            hung = []
            with shared["lock"]:
                if shared["stop"] is not None:
                    return
                for ti, (started, src) in shared["inflight"].items():
                    if shared["taskdone"][ti]:
                        continue
                    if now - started >= policy.fail_detect:
                        prev = last_report.get(src)
                        if prev is None or now - prev >= policy.fail_detect:
                            last_report[src] = now
                            hung.append((src, tasks[ti].unit))
            for src, unit in hung:
                if rec.enabled:
                    rec.counter_add(obs.CTR_DEADLINE_REPORTS, 1)
                    rec.event(
                        "read_deadline", track=track, source=src, unit=unit,
                    )
                self._report_suspect(dest_name, src, "transient")
            try:
                with self._cv:
                    ep = self._scall(
                        "assignment_epoch", self.model, dest_name, version
                    )
            except ServerUnavailableError:
                raise  # dead controller, not a dead source/handle
            except (StaleHandleError, TensorHubError):
                continue  # workers surface dest eviction themselves
            if ep != shared["epoch"]:
                self._span_stop(shared, "replan")
                return
        # done_ev set: all tasks claimed complete, or a worker stopped us

    def _report_suspect(self, dest_name: str, source: str, evidence: str) -> None:
        """Report non-fatal evidence against a source without waiting for
        a re-route (the monitor keeps polling the epoch instead)."""
        try:
            with self._cv:
                self._scall(
                    "report_transfer_failure",
                    self.model, dest_name, source, evidence,
                    self.client.clock(),
                )
        except ServerUnavailableError:
            raise
        except (StaleHandleError, TensorHubError):
            pass  # handle churn mid-report: the epoch poll handles it

    def _retry_transient(self, fn, source: str, *, unit=None):
        """Run a transport read, retrying transient failures with
        exponential backoff up to ``retry_policy.retry_limit`` attempts
        before letting the error escalate to the failure reporter."""
        policy = self.client.retry_policy
        rec = self.client.recorder
        attempt = 0
        while True:
            try:
                return fn()
            except TransportError as e:
                if not getattr(e, "transient", False) or attempt >= policy.retry_limit:
                    raise
                attempt += 1
                if rec.enabled:
                    rec.counter_add(obs.CTR_RETRIES, 1)
                    rec.event(
                        "retry", track=self.worker.worker_id,
                        source=source, unit=unit, attempt=attempt,
                    )
                time.sleep(policy.backoff(attempt))

    def _hedge_pick(self, shared: dict, sl: SourceSlice, avail: int):
        """Pick a straggling in-flight task worth duplicating onto this
        (idle) source: oldest read exceeding ``hedge_threshold`` × the
        median completed-read duration, owned by a different source, not
        already hedged, and within this source's served prefix. Both
        copies race; the first to finish claims the task, the loser's
        byte-identical result is discarded."""
        policy = self.client.retry_policy
        with shared["lock"]:
            if shared["stop"] is not None:
                return None
            durs = shared["durations"]
            if len(durs) < policy.hedge_min_samples:
                return None
            med = sorted(durs)[len(durs) // 2]
            threshold = policy.hedge_threshold * max(med, 1e-6)
            now = self.client.clock()
            tasks: List[_PullTask] = shared["tasks"]
            pick = None
            oldest = None
            for ti, (started, src) in shared["inflight"].items():
                if src == sl.source or ti in shared["hedged"]:
                    continue
                if shared["taskdone"][ti] or tasks[ti].unit >= avail:
                    continue
                age = now - started
                if age >= threshold and (oldest is None or age > oldest):
                    oldest = age
                    pick = ti
            if pick is not None:
                shared["hedged"].add(pick)
            return pick

    def _span_worker(
        self,
        sl: SourceSlice,
        shared: dict,
        dest_name: str,
        dest_store: WorkerStore,
        manifest,
        version: int,
    ) -> None:
        tasks: List[_PullTask] = shared["tasks"]
        claimed: List[bool] = shared["claimed"]
        rec = self.client.recorder
        policy = self.client.retry_policy
        try:
            while True:
                with shared["lock"]:
                    if (
                        shared["stop"] is not None
                        or shared["ntaskdone"] == len(tasks)
                    ):
                        return
                with self._cv:
                    try:
                        ep = self._scall(
                            "assignment_epoch", self.model, dest_name, version
                        )
                    except ServerUnavailableError:
                        raise  # dead controller, not a dead source/handle
                    except (StaleHandleError, TensorHubError) as e:
                        if self._inflight is not None and dest_name == self.replica:
                            # our own in-progress state is missing — not an
                            # eviction but a controller failover that lost
                            # it; drain the span so the outer loop can
                            # re-establish and resume from the prefix
                            self._span_stop(shared, "replan")
                        else:
                            self._span_stop(shared, e)  # dest evicted mid-pull
                        return
                    try:
                        avail = self._scall(
                            "shard_progress",
                            self.model, sl.source, version, self.shard_idx,
                        )
                    except ServerUnavailableError:
                        raise  # dead controller, not a dead source/handle
                    except (StaleHandleError, TensorHubError):
                        raise _SourceLost(sl.source)
                if ep != shared["epoch"]:
                    self._span_stop(shared, "replan")
                    return
                pick = None
                hedged = False
                with shared["lock"]:
                    while shared["scan"] < len(tasks) and claimed[shared["scan"]]:
                        shared["scan"] += 1
                    for i in range(shared["scan"], len(tasks)):
                        if not claimed[i] and tasks[i].unit < avail:
                            pick = i
                            claimed[i] = True
                            shared["unclaimed"] -= 1
                            break
                if pick is None:
                    # nothing unclaimed this source can serve: duplicate
                    # the slowest foreign in-flight read instead of idling
                    # (bounds single-source straggling at roughly the
                    # healthy source's speed)
                    pick = self._hedge_pick(shared, sl, avail)
                    if pick is not None:
                        hedged = True
                        if rec.enabled:
                            rec.counter_add(obs.CTR_HEDGES, 1)
                            rec.event(
                                "hedge", track=self.worker.worker_id,
                                source=sl.source, unit=tasks[pick].unit,
                            )
                if pick is None:
                    # nothing this source can serve yet: wait for progress
                    with self._cv:
                        self.client._wait(_POLL)
                    continue
                shared["sem"].acquire()
                try:
                    if shared["stop"] is not None:
                        return  # abandoned claim; the re-plan re-lists it
                    try:
                        self._retry_transient(
                            lambda: self._fetch_task(
                                pick, tasks[pick], sl, shared, dest_name,
                                dest_store, manifest, version,
                            ),
                            sl.source,
                            unit=tasks[pick].unit,
                        )
                    except (ChecksumError, codec_lib.CodecError):
                        # corrupt bytes OR a torn/misframed wire frame
                        # (CodecError from decode): report, bounded per
                        # unit — if every re-plan keeps rejecting this
                        # unit the data is genuinely bad and the error
                        # propagates. Delta-base staleness never lands
                        # here; the transport handles it internally.
                        u = tasks[pick].unit
                        with shared["lock"]:
                            n = shared["rejects"].get(u, 0) + 1
                            shared["rejects"][u] = n
                        if n > policy.retry_limit:
                            raise
                        if rec.enabled:
                            rec.counter_add(obs.CTR_CORRUPT_REJECTS, 1)
                            rec.event(
                                "corrupt_reject", track=self.worker.worker_id,
                                source=sl.source, unit=u,
                            )
                        self._span_stop(
                            shared, _SourceLost(sl.source, evidence="corrupt")
                        )
                        return
                finally:
                    shared["sem"].release()
                if hedged:
                    continue  # twin may still hold the claim; keep going
        except TransportError as e:
            if dest_store.failed:
                # our own store died (dest preemption), not the source
                self._span_stop(shared, e)
            else:
                self._span_stop(
                    shared,
                    _SourceLost(
                        sl.source,
                        evidence="transient"
                        if getattr(e, "transient", False)
                        else "fatal",
                    ),
                )
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            self._span_stop(shared, e)

    def _fetch_task(
        self,
        ti: int,
        t: _PullTask,
        sl: SourceSlice,
        shared: dict,
        dest_name: str,
        dest_store: WorkerStore,
        manifest,
        version: int,
    ) -> None:
        unit = manifest.units[t.unit]
        if not codec_lib.get_codec(sl.codec).lossless:
            # decoded bytes won't match the publish-time checksum: mark
            # the unit before any finish check can verify it
            with shared["lock"]:
                shared["lossy_units"].add(t.unit)
        whole = t.offset == 0 and t.nbytes == unit.nbytes
        rec = self.client.recorder
        track = self.worker.worker_id
        lc = _link_class(sl.source, sl.transport)
        started = self.client.clock()
        with shared["lock"]:
            if shared["stop"] is not None or shared["taskdone"][ti]:
                return  # span drained / hedge twin already won
            shared["inflight"][ti] = (started, sl.source)
        sp = None
        if rec.enabled:
            t0 = rec.clock()
            sp = rec.span(
                "pull_unit" if whole else "pull_chunk",
                track=track, source=sl.source, codec=sl.codec,
                unit=unit.name, bytes=t.nbytes, link_class=lc,
            )
        try:
            if whole:
                self.client.transport.pull_unit(
                    sl.source, self.shard_idx, unit, manifest.checksums[t.unit],
                    dest_store, codec=sl.codec, link_class=lc,
                )
            else:
                dbase = None
                if getattr(codec_lib.get_codec(sl.codec), "needs_base", False):
                    # delta chunk: hand the transport the destination's
                    # held bytes for this exact range (the base buffers
                    # stay intact until the reassembled unit is absorbed)
                    held = self.client.transport._dest_base(dest_store, unit)
                    if held is not None and held.nbytes == unit.nbytes:
                        dbase = held[t.offset : t.offset + t.nbytes]
                payload = self.client.transport.read_unit_range(
                    sl.source, self.shard_idx, unit, t.offset, t.nbytes,
                    codec=sl.codec, link_class=lc, dest_base=dbase,
                    device=dest_store.device,
                )
        finally:
            if sp is not None:
                sp.end()
                rec.counter_add(obs.CTR_WIRE, rec.clock() - t0)
            with shared["lock"]:
                cur = shared["inflight"].get(ti)
                if cur is not None and cur[1] == sl.source:
                    del shared["inflight"][ti]
        alldone = False
        with shared["lock"]:
            if shared["stop"] is not None:
                return  # span drained while we were on the wire
            if shared["taskdone"][ti]:
                return  # hedge twin won the race; identical bytes, drop
            shared["taskdone"][ti] = True
            shared["ntaskdone"] += 1
            alldone = shared["ntaskdone"] == len(shared["tasks"])
            shared["durations"].append(self.client.clock() - started)
        if not whole:
            with shared["lock"]:
                buf = shared["staging"].get(t.unit)
                if buf is None:
                    buf = shared["staging"][t.unit] = torch.empty(
                        unit.nbytes, dtype=torch.uint8, device=dest_store.device
                    )
            asm = (
                rec.span("reassemble", track=track, unit=unit.name, bytes=t.nbytes)
                if rec.enabled
                else None
            )
            buf[t.offset : t.offset + t.nbytes] = payload
            if asm is not None:
                asm.end()
        with shared["lock"]:
            shared["remaining"][t.unit] -= 1
            finished = shared["remaining"][t.unit] == 0
            buf = shared["staging"].pop(t.unit, None) if finished else None
            unit_lossy = t.unit in shared["lossy_units"]
        if not finished:
            if alldone:
                shared["done_ev"].set()
            return
        if buf is not None:  # chunked unit: verify end-to-end, then absorb
            # lossy-coded chunks were each verified over their decoded
            # bytes; the publish-time manifest checksum only applies to
            # raw (bit-exact) reassembly
            expected = 0 if unit_lossy else manifest.checksums[t.unit]
            if self.client.transport.verify_checksums and expected:
                t0 = rec.clock() if rec.enabled else 0.0
                got = checksum_lib.checksum(buf)
                if rec.enabled:
                    rec.counter_add(obs.CTR_VERIFY, rec.clock() - t0)
                    rec.event("verify", track=track, unit=unit.name)
                if got != expected:
                    n_chunks = -(-unit.nbytes // (self.chunk_bytes or unit.nbytes))
                    raise ChecksumError(
                        f"unit {unit.name} reassembled from {n_chunks} "
                        f"chunks: checksum {got:#x} != expected {expected:#x}"
                    )
            dest_store.write_unit(unit, buf)
        advanced = False
        with shared["lock"]:
            if shared["stop"] is None:  # a drained span re-lists the unit
                shared["completed"].add(t.unit)
                while shared["done"] in shared["completed"]:
                    shared["done"] += 1
                    advanced = True
                new_done = shared["done"]
                if advanced:
                    # monotone advance before the server learns; max()
                    # because a hedged span can finish units out of the
                    # order their prefix updates land
                    sp_cur = dest_store.serving_prefix
                    if sp_cur is not None:
                        dest_store.serving_prefix = max(sp_cur, new_done)
        if advanced:
            if rec.enabled:
                rec.event("prefix_advance", track=track, done=new_done)
            with self._cv:
                self._scall(
                    "update_progress",
                    self.model, dest_name, self.shard_idx, version, new_done,
                )
        if alldone:
            shared["done_ev"].set()

    def _pull_resharded_span(
        self,
        assignment: Assignment,
        dest_name: str,
        dest_store: WorkerStore,
        done: int,
        rejects: Optional[Dict[int, int]] = None,
    ) -> int:
        """Cross-layout pull: plan row-grid-aligned interval reads
        against the source layout, fetch them window-parallel, assemble
        each destination unit, publish unit progress. Starts at
        destination unit ``done`` (resume).

        The negotiated wire codec flows through the plan:
        ``reshard_wire_codec`` resolves the assignment's codec to one an
        interval read can carry (delta falls back to its int8 base — no
        held prior version exists at interval granularity), the planner
        widens every read to that codec's quantization row grid, and a
        lossy codec takes the fused path — intervals arrive as undecoded
        wire frames (``decode=False``) and ``ReshardExecutor.
        fused_repack`` dequantizes them straight into the unit payload,
        overlapped against the next unit's in-flight reads. A raw
        negotiation keeps the staged decode+repack path and stays
        bit-exact with the pre-codec planner (zero widening).
        """
        from repro_torch.resharding import ReshardExecutor, layout_from_manifests, plan_shard

        codec = codec_lib.reshard_wire_codec(assignment.codec)
        fused = codec != "raw"
        version = assignment.version
        # our own layout family: checksums are disabled because they would
        # be computed over the *pre-pull* buffer contents; same-layout
        # readers chaining off us skip per-unit verification (zeros).
        local_manifest = dest_store.build_manifest(with_checksums=False)
        with self._cv:
            self._scall(
                "put_manifest",
                self.model, dest_name, self.shard_idx, version, local_manifest
            )
        src_n = assignment.source_shards or self.num_shards
        src_manifests = {
            s: self._wait_src_manifest(version, assignment.source, shard_idx=s)
            for s in range(src_n)
        }
        src_layout = layout_from_manifests(src_manifests, src_n)
        dst_layout = layout_from_manifests(
            {self.shard_idx: local_manifest}, self.num_shards
        )
        plan = plan_shard(
            src_layout,
            dst_layout,
            self.shard_idx,
            num_dest_units=local_manifest.num_units,
            codec=codec,
        )
        # staging and the repack live on the destination store's device: on
        # the card the gather and fused dequant+gather kernels run (or
        # raise); the host-RAM seed/offload twin stores are on the CPU by
        # design and reshard there through the plain versions
        executor = ReshardExecutor(
            plan, local_manifest, device=dest_store.device,
            use_kernel=self.device_repack,
        )
        source = assignment.source
        rec = self.client.recorder
        track = self.worker.worker_id
        lc = _link_class(source, assignment.transport)
        policy = self.client.retry_policy
        if rejects is None:
            rejects = {}
        count_lock = threading.Lock()

        def fetch_one(p):
            iv = p.interval
            self._await_source_progress(
                source, version, iv.source_shard, iv.source_unit
            )
            src_unit = src_manifests[iv.source_shard].units[iv.source_unit]
            t0 = rec.clock() if rec.enabled else 0.0
            try:
                payload = self._retry_transient(
                    lambda: self.client.transport.read_unit_range(
                        source, iv.source_shard, src_unit, iv.read_offset,
                        iv.read_nbytes, codec=codec, link_class=lc,
                        decode=not fused, device=dest_store.device,
                    ),
                    source,
                    unit=iv.tensor,
                )
            finally:
                if rec.enabled:
                    rec.counter_add(obs.CTR_WIRE, rec.clock() - t0)
            with count_lock:
                self.intervals_pulled += 1
            return payload

        def start_fetch(placed):
            """Kick off window-parallel interval reads for one
            destination unit; returns a ``join()`` that blocks and
            yields payloads in plan order (or re-raises the first
            worker failure)."""
            results: List[Optional[torch.Tensor]] = [None] * len(placed)
            errors: List[BaseException] = []
            cursor = [0]

            def work():
                while True:
                    with count_lock:
                        if errors or cursor[0] >= len(placed):
                            return
                        i = cursor[0]
                        cursor[0] += 1
                    try:
                        results[i] = fetch_one(placed[i])
                    except BaseException as e:  # carried to join()
                        with count_lock:
                            errors.append(e)
                        return

            n = max(1, min(self.window, len(placed)))
            threads = [
                threading.Thread(
                    target=work, daemon=True,
                    name=f"{track}-reshard-fetch-{k}",
                )
                for k in range(n)
            ]
            for t in threads:
                t.start()

            def join():
                for t in threads:
                    t.join()
                if errors:
                    raise errors[0]
                return results

            return join

        batches = list(executor.unit_batches(start_unit=done))
        join = None
        for j, (unit, placed) in enumerate(batches):
            if join is None:
                join = start_fetch(placed)
            try:
                payloads = join()
            except TransportError as e:
                raise _SourceLost(
                    source,
                    evidence="transient"
                    if getattr(e, "transient", False)
                    else "fatal",
                )
            except (ChecksumError, codec_lib.CodecError):
                # corrupt interval from this source: same healing as the
                # unit pipe — report the evidence, bounded per dest unit
                rejects[unit.index] = rejects.get(unit.index, 0) + 1
                if rejects[unit.index] > policy.retry_limit:
                    raise
                if rec.enabled:
                    rec.counter_add(obs.CTR_CORRUPT_REJECTS, 1)
                    rec.event(
                        "corrupt_reject", track=track, source=source,
                        unit=unit.name,
                    )
                raise _SourceLost(source, evidence="corrupt")
            join = None
            if j + 1 < len(batches):
                # overlap: the next unit's reads fly while this unit
                # decodes + repacks (the windowed-flow analogue for the
                # interval plane)
                join = start_fetch(batches[j + 1][1])
            t0 = rec.clock() if rec.enabled else 0.0
            if fused:
                payload = executor.fused_repack(unit.index, payloads)
            else:
                # one device copy per interval into the unit's staging
                staging = executor.make_staging(unit.index)
                for p, pay in zip(placed, payloads):
                    iv = p.interval
                    staging[
                        p.staging_offset : p.staging_offset + iv.nbytes
                    ].copy_(pay[iv.lead : iv.lead + iv.nbytes])
                payload = executor.repack(unit.index, staging)
            if rec.enabled:
                rec.counter_add(obs.CTR_DECODE, rec.clock() - t0)
            dest_store.write_unit(unit, payload)
            done += 1
            dest_store.serving_prefix = done  # before the server learns
            with self._cv:
                self._scall(
                    "update_progress",
                    self.model, dest_name, self.shard_idx, version, done,
                )
        return done

    def _await_source_progress(
        self, source: str, version: int, src_shard: int, needed: int
    ) -> int:
        """Block until the source shard's progress counter exceeds
        ``needed`` (pipeline replication gating); raises
        :class:`_SourceLost` if the source is evicted meanwhile."""
        with self._cv:
            while True:
                try:
                    avail = self._scall(
                        "shard_progress", self.model, source, version, src_shard
                    )
                except ServerUnavailableError:
                    raise  # dead controller, not a dead source/handle
                except (StaleHandleError, TensorHubError):
                    raise _SourceLost(source)
                if avail > needed:
                    return avail
                self.client._wait(_POLL)

    def _handle_source_failure(
        self, dest_name: str, dead_source: str, evidence: str = "fatal"
    ) -> Assignment:
        """Report a failed source and wait for the server to re-route us.

        ``evidence`` classifies what we saw: ``"fatal"`` evicts the
        source, ``"transient"``/``"corrupt"`` strike-count it toward
        quarantine (the server re-plans around a quarantined source but
        keeps it registered)."""
        with self._cv:
            self._scall(
                "report_transfer_failure",
                self.model, dest_name, dead_source, evidence,
                self.client.clock(),
            )
            while True:
                new = self._scall("get_assignment", self.model, dest_name)
                if new is not None:
                    rec = self.client.recorder
                    if rec.enabled:
                        rec.event(
                            "epoch_bump", track=self.worker.worker_id,
                            epoch=new.epoch, dead_source=dead_source,
                        )
                    return new
                self.client._wait(_POLL)

    # -- offload seeding (4.3.4) -----------------------------------------------------------

    def _spawn_seed_pull(self, version: int) -> None:
        if version in self._seed_threads:
            return
        t = threading.Thread(
            target=self._seed_pull_guarded, args=(version,), daemon=True,
            name=f"{self.worker.worker_id}-seed-v{version}",
        )
        self._seed_threads[version] = t
        t.start()

    def _seed_pull_guarded(self, version: int) -> None:
        """Seed pulls run in a daemon thread with no caller to raise to:
        on failure (e.g. a non-convertible layout surfacing as
        ShardLayoutError mid-plan) fail the twin so the server unwinds
        its in-progress state and source refcounts, instead of leaving a
        forever-IN_PROGRESS seeder that blocks smart skipping."""
        twin = offload_name(self.replica)
        try:
            self._seed_pull(version)
        except TensorHubError as e:
            import logging

            logging.getLogger(__name__).warning(
                "%s: offload seed pull of v%s failed: %s", twin, version, e
            )
            with self._cv:
                try:
                    self._server.fail_replica(self.model, twin, reason=str(e))
                except TensorHubError:
                    pass

    def _seed_pull(self, version: int) -> None:
        """Background cross-DC fetch into a CPU buffer; the accelerator keeps
        computing and a later update() consumes the completed seed locally."""
        twin = offload_name(self.replica)
        # seed buffers mirror our registered shard (same local layout), so
        # the twin can be fed by a cross-layout source and later consumed
        # locally over PCIe without any further conversion
        buffers = {
            n: torch.zeros_like(a, device="cpu") for n, a in self.store.tensors().items()
        }
        off_store = WorkerStore(f"{self.worker.worker_id}@seed", device="cpu")
        off_store.register(buffers, layout=self.store.layouts)
        self._offload_stores[version] = off_store
        self.client.registry.add(twin, self.shard_idx, off_store)
        with self._cv:
            assignment = None
            while assignment is None:
                assignment = self._scall("get_assignment", self.model, twin)
                if assignment is None:
                    self.client._wait(_POLL)
        self._pull(
            assignment,
            op_id=self._next_off_op(),
            dest_name=twin,
            dest_store=off_store,
            twin=True,
        )
