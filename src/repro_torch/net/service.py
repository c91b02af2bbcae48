"""Transport-agnostic control-plane service.

``ReferenceService`` is the seam the tentpole split introduces: all
server *logic* stays in :class:`repro_torch.core.server.ReferenceServer`
(deterministic, single-threaded semantics, WAL-logged), and everything a
transport needs — frame decoding, op whitelisting, cross-thread
serialization, typed-error encoding, per-RPC latency stats, the worker
peer directory, and the heartbeat-expiry ticker — lives here, with no
socket in sight. The HTTP layer (:mod:`repro_torch.net.httpd`) is a thin shim
over :meth:`handle_frame`; the protocol-fuzz tests drive the same entry
point in-process.

Idempotent redelivery comes for free: every mutating group op carries an
``op_id`` and the server's done-txn cache replays the cached result on
re-delivery, so a client may retry any request whose response was lost
to a dropped connection. The remaining mutating ops (progress reports,
heartbeats, manifest puts) are idempotent by construction.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.errors import TensorHubError
from repro_torch.core.oplog import OP_SCHEMAS
from repro_torch.core.server import CONTROL_OPS, ReferenceServer
from repro_torch.net import protocol
from repro_torch.net.protocol import ProtocolError
from repro_torch.obs.rpc import RpcStats

#: service-level ops (not server methods, never WAL-logged): the peer
#: directory that stands in for the paper's RDMA address exchange, plus
#: introspection used by tests and the failover watcher.
SERVICE_OPS: Dict[str, tuple] = {
    "svc.ping": (),
    "svc.digest": (),
    "svc.metrics": (),
    "svc.announce": ("worker_id", "replica", "shard_idx", "address"),
    "svc.retract": ("replica", "shard_idx"),
    "svc.peer": ("replica", "shard_idx"),
    "svc.peers": (),
}


class ReferenceService:
    """One server, any number of transports.

    All dispatch is serialized on an internal lock: the server keeps its
    deterministic single-threaded semantics no matter how many transport
    threads (or in-process callers) push frames in.
    """

    def __init__(
        self,
        server: ReferenceServer,
        *,
        clock: Callable[[], float] = time.time,
        tick_interval: Optional[float] = None,
    ) -> None:
        self.server = server
        self.clock = clock
        self.rpc_stats = RpcStats()
        self._lock = threading.RLock()
        #: (replica, shard_idx) -> data-plane address ("host:port").
        #: Deliberately *not* part of the server's replayed state:
        #: addresses are ephemeral transport facts, so the service-wrapped
        #: server stays digest-identical to an in-process twin. After a
        #: controller restart the directory starts empty and workers
        #: re-announce (the address watcher does this before failing
        #: clients over); readers retry unresolved peers as transient.
        self._peers: Dict[Tuple[str, int], str] = {}
        self._peer_owner: Dict[Tuple[str, int], str] = {}
        self._started = clock()
        self._stop = threading.Event()
        self._ticker: Optional[threading.Thread] = None
        #: liveness monitoring: on when the ticker drives wall-clock
        #: expiry sweeps. The server seeds a fresh shard's last_heartbeat
        #: at 0.0 (virtual-time tests rely on that), which an epoch-clock
        #: tick would read as "stale since 1970" — so while monitoring,
        #: dispatch stamps a first heartbeat the instant an open lands,
        #: under the same lock (no tick can interleave).
        self._monitor = tick_interval is not None
        if tick_interval is not None:
            self.start_ticker(tick_interval)

    # -- dispatch --------------------------------------------------------------

    def dispatch(self, op: str, args: List[Any], kw: Dict[str, Any]) -> Any:
        """Invoke one whitelisted op; raises typed errors on failure."""
        if op.startswith("svc."):
            if op not in SERVICE_OPS:
                raise ProtocolError(f"unknown service op {op!r}")
            return self._service_op(op, args, kw)
        if op not in CONTROL_OPS:
            raise ProtocolError(f"op {op!r} is not a remotable control op")
        with self._lock:
            result = getattr(self.server, op)(*args, **kw)
            if op == "open" and self._monitor:
                merged = dict(zip(OP_SCHEMAS["open"], args))
                merged.update(kw)
                try:
                    self.server.heartbeat(
                        merged["model"], merged["replica"],
                        merged["shard_idx"], self.clock(),
                    )
                except (TensorHubError, KeyError):
                    pass
            return result

    def handle_frame(self, data: bytes) -> bytes:
        """Decode one request frame, dispatch it, encode the outcome.

        Total by construction: every failure — protocol violation, typed
        control-plane error, even an encoding bug — becomes a well-formed
        error frame. A transport never needs to disconnect on a bad
        request, and a fuzzer cannot make this raise."""
        t0 = time.perf_counter()
        op = "malformed"
        try:
            op, args, kw = protocol.decode_request(data)
            result = self.dispatch(op, args, kw)
            out = protocol.encode_result(result)
        except BaseException as e:  # noqa: BLE001 — the wire carries it
            self.rpc_stats.record(op, time.perf_counter() - t0, ok=False)
            return protocol.encode_error(e)
        self.rpc_stats.record(op, time.perf_counter() - t0)
        return out

    def call(self, op: str, *args: Any, **kw: Any) -> Any:
        """In-process convenience entry with the same validation path as
        a decoded frame (used by tests and the ticker)."""
        return self.dispatch(op, list(args), kw)

    # -- service ops -----------------------------------------------------------

    def _service_op(self, op: str, args: List[Any], kw: Dict[str, Any]) -> Any:
        try:
            if op == "svc.ping":
                return {
                    "service": "tensorhub-controller",
                    "protocol": protocol.PROTOCOL_VERSION,
                    "started": self._started,
                    "crashed": bool(self.server.is_crashed),
                }
            if op == "svc.digest":
                from repro_torch.core import failover

                with self._lock:
                    return failover.state_digest(self.server)
            if op == "svc.metrics":
                return self.metrics()
            if op == "svc.announce":
                worker_id, replica, shard_idx, address = args
                with self._lock:
                    self._peers[(replica, int(shard_idx))] = str(address)
                    self._peer_owner[(replica, int(shard_idx))] = str(worker_id)
                return None
            if op == "svc.retract":
                replica, shard_idx = args
                with self._lock:
                    self._peers.pop((replica, int(shard_idx)), None)
                    self._peer_owner.pop((replica, int(shard_idx)), None)
                return None
            if op == "svc.peer":
                replica, shard_idx = args
                with self._lock:
                    return self._peers.get((replica, int(shard_idx)))
            if op == "svc.peers":
                with self._lock:
                    return {k: v for k, v in self._peers.items()}
        except (TypeError, ValueError) as e:
            raise ProtocolError(f"bad arguments for {op}: {e}") from None
        raise ProtocolError(f"unknown service op {op!r}")  # pragma: no cover

    # -- metrics ---------------------------------------------------------------

    def metrics(self) -> Dict[str, Dict[str, Any]]:
        """The server's metrics plus the transport's per-RPC section."""
        with self._lock:
            m = dict(self.server.metrics())
        m["rpc"] = self.rpc_stats.snapshot()
        return m

    def metrics_text(self) -> str:
        """One scrape body: server exposition + per-RPC series."""
        with self._lock:
            body = self.server.metrics_text()
        return body + self.rpc_stats.text()

    # -- heartbeat-expiry ticker ----------------------------------------------

    def start_ticker(self, interval: float) -> None:
        """Drive ``server.tick`` on the service clock so stale worker
        heartbeats expire (eviction + quarantine-probation lifts) without
        any client's help — the langport-controller shape. Each tick is a
        logged op with its explicit timestamp, so a WAL replay evicts the
        same replicas the live run did."""
        if self._ticker is not None:
            return
        self._monitor = True

        def loop() -> None:
            while not self._stop.wait(interval):
                try:
                    with self._lock:
                        if self.server.is_crashed:
                            continue
                        self.server.tick(self.clock())
                except TensorHubError:
                    continue

        self._ticker = threading.Thread(
            target=loop, name="tensorhub-ticker", daemon=True
        )
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=2.0)
            self._ticker = None


__all__ = ["ReferenceService", "SERVICE_OPS"]
