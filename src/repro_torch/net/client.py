"""Worker-side proxy for the networked control plane.

``RemoteClient`` is shaped like a :class:`~repro_torch.core.server
.ReferenceServer`: every remotable op is a method, typed errors re-raise
as themselves, and ``add_watcher`` exists — so it drops straight into
``TensorHubClient(server=...)`` and the entire client stack (parking,
two-phase reassert, retry policy) works over sockets unchanged.

Connection-level failures (refused, reset, timed out) surface as
:class:`~repro_torch.core.errors.ServerUnavailableError` — indistinguishable
from a ``crash()``ed in-process server, which is exactly right: the
client parks and waits for ``failover()``. Whether a retry is safe is
the *server's* problem, and it already solved it: group ops are
idempotent via their op-id done-txn cache, everything else by
construction, so ``RemoteClient`` retries once on a stale kept-alive
connection before giving up.

``AddressWatcher`` closes the loop for controller restarts: it polls the
address file the controller publishes, and when a *new* address answers
``svc.ping`` it re-announces this worker's data-plane peers (the
directory is ephemeral) and fails the ``TensorHubClient`` over to a
fresh ``RemoteClient`` — parked ops then reassert and resume.
"""

from __future__ import annotations

import http.client
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.errors import ServerUnavailableError
from repro_torch.core.oplog import OP_SCHEMAS
from repro_torch.core.server import CONTROL_OPS
from repro_torch.net import protocol
from repro_torch.net.httpd import split_address

#: network faults that mean "controller unreachable", not "op failed"
_CONN_ERRORS = (
    ConnectionError,
    socket.timeout,
    http.client.HTTPException,
    OSError,
)


class RemoteClient:
    """Server-shaped HTTP proxy speaking the versioned frame protocol.

    One persistent keep-alive connection, guarded by a lock so a single
    ``RemoteClient`` may be shared the way an in-process server is."""

    def __init__(self, address: str, *, timeout: float = 10.0) -> None:
        self.address = address
        self.host, self.port = split_address(address)
        self.timeout = timeout
        self._lock = threading.Lock()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._watchers: List[Callable[[], None]] = []
        self._unavailable = False

    # -- transport -------------------------------------------------------------

    def _post(self, frame: bytes) -> bytes:
        """POST one frame, reusing the kept-alive connection; one silent
        retry on a fresh connection covers the server having closed the
        idle socket between ops."""
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        conn = http.client.HTTPConnection(
                            self.host, self.port, timeout=self.timeout
                        )
                        conn.connect()
                        # latency-bound request/response pairs: Nagle
                        # plus delayed ACK would idle ~40ms per op
                        conn.sock.setsockopt(
                            socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                        )
                        self._conn = conn
                    self._conn.request(
                        "POST",
                        "/rpc",
                        body=frame,
                        headers={"Content-Type": "application/json"},
                    )
                    resp = self._conn.getresponse()
                    return resp.read()
                except _CONN_ERRORS as e:
                    self._drop_conn()
                    if attempt == 1:
                        self._unavailable = True
                        raise ServerUnavailableError(
                            f"controller {self.address} unreachable: {e}"
                        ) from None
        raise AssertionError("unreachable")

    def _drop_conn(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None

    def call(self, op: str, *args: Any, **kw: Any) -> Any:
        out = self._post(protocol.encode_request(op, args, kw))
        result = protocol.decode_response(out)
        if op in OP_SCHEMAS:
            # mirror the in-process server's _bump for self-induced
            # state changes: a mutating op just landed, so wake this
            # process's waiters immediately instead of letting them eat
            # a full re-poll quantum. Changes made by *other* processes
            # still surface on the poll cadence — same guarantee, just
            # slower, which is all a remote watcher can promise.
            for cb in list(self._watchers):
                try:
                    cb()
                except Exception:
                    pass
        return result

    def close(self, *args: Any, **kw: Any) -> Any:
        """The one name both surfaces claim: with arguments this proxies
        the server's ``close(model, replica, shard_idx)`` op; a bare
        ``close()`` tears down this client's connection."""
        if args or kw:
            return self.call("close", *args, **kw)
        with self._lock:
            self._drop_conn()

    # -- the server interface --------------------------------------------------

    def __getattr__(self, name: str) -> Callable[..., Any]:
        # only the declared remotable surface; anything else is a
        # programming error, same as a missing server method
        if name.startswith("_") or name not in CONTROL_OPS:
            raise AttributeError(name)

        def method(*args: Any, **kw: Any) -> Any:
            return self.call(name, *args, **kw)

        method.__name__ = name
        return method

    def add_watcher(self, cb: Callable[[], None]) -> None:
        # fired after this client's own mutating ops (see call()); for
        # changes originating elsewhere the waiters' re-poll cadence is
        # the wakeup, as with any remote watcher
        self._watchers.append(cb)

    @property
    def is_crashed(self) -> bool:
        if self._unavailable:
            return True
        try:
            return bool(self.ping().get("crashed"))
        except ServerUnavailableError:
            return True

    # -- service ops -----------------------------------------------------------

    def ping(self) -> Dict[str, Any]:
        return self.call("svc.ping")

    def digest(self) -> str:
        return self.call("svc.digest")

    def announce_peer(
        self, worker_id: str, replica: str, shard_idx: int, address: str
    ) -> None:
        self.call("svc.announce", worker_id, replica, shard_idx, address)

    def retract_peer(self, replica: str, shard_idx: int) -> None:
        self.call("svc.retract", replica, shard_idx)

    def peer_addr(self, replica: str, shard_idx: int) -> Optional[str]:
        return self.call("svc.peer", replica, shard_idx)

    def peers(self) -> Dict[Tuple[str, int], str]:
        return self.call("svc.peers")

    def service_metrics(self) -> Dict[str, Any]:
        return self.call("svc.metrics")


# ---------------------------------------------------------------------------
# controller address file + failover watcher
# ---------------------------------------------------------------------------


def write_address(path: str, address: str) -> None:
    """Atomically publish the controller's address (rename, so a reader
    never sees a torn write)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(address + "\n")
    os.replace(tmp, path)


def read_address(path: str) -> Optional[str]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            addr = fh.read().strip()
    except FileNotFoundError:
        return None
    return addr or None


class AddressWatcher:
    """Fail a ``TensorHubClient`` over when the controller moves.

    Polls ``addr_file``; when it names an address different from the one
    the hub client is currently wired to *and* that address answers
    ``svc.ping``, re-announces this worker's data-plane peers on the new
    controller (its directory starts empty after a restart) and calls
    ``hub_client.failover(RemoteClient(new_addr))`` — parked ops wake,
    reassert their session state, and resume."""

    def __init__(
        self,
        hub_client: Any,
        addr_file: str,
        *,
        poll_interval: float = 0.2,
        peers: Optional[Callable[[], List[Tuple[str, str, int, str]]]] = None,
        timeout: float = 10.0,
    ) -> None:
        self.hub_client = hub_client
        self.addr_file = addr_file
        self.poll_interval = poll_interval
        self._peers = peers
        self._timeout = timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def current_address(self) -> Optional[str]:
        server = self.hub_client.server
        return getattr(server, "address", None)

    def check_once(self) -> bool:
        """One poll step; returns True when a failover happened."""
        addr = read_address(self.addr_file)
        if addr is None or addr == self.current_address():
            return False
        candidate = RemoteClient(addr, timeout=self._timeout)
        try:
            candidate.ping()
        except ServerUnavailableError:
            candidate.close()
            return False
        # announce before failover: by the time parked readers resume,
        # the new controller can already resolve this worker's stores
        if self._peers is not None:
            for worker_id, replica, shard_idx, peer_addr in self._peers():
                candidate.announce_peer(worker_id, replica, shard_idx, peer_addr)
        self.hub_client.failover(candidate)
        return True

    def start(self) -> "AddressWatcher":
        def loop() -> None:
            while not self._stop.wait(self.poll_interval):
                try:
                    self.check_once()
                except Exception:
                    # a torn file read or race with a dying controller
                    # must not kill the watcher; next poll retries
                    time.sleep(self.poll_interval)

        self._thread = threading.Thread(
            target=loop, name="tensorhub-addr-watcher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


__all__ = [
    "AddressWatcher",
    "RemoteClient",
    "read_address",
    "write_address",
]
