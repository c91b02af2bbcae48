"""One-call assembly of a networked worker process.

``NetWorker`` wires together everything a worker needs to participate in
the socketed deployment: a :class:`~repro_torch.net.client.RemoteClient` to
the controller, a local :class:`~repro_torch.transfer.engine.WorkerRegistry`
that *announces* every registered store to the controller's peer
directory, a :class:`~repro_torch.net.data.WorkerDataServer` serving those
stores to other workers, a :class:`~repro_torch.net.data.RemoteTransport`
resolving non-local sources through the directory, ambient wall-clock
heartbeats, and (optionally) an :class:`~repro_torch.net.client
.AddressWatcher` that fails the whole stack over when the controller
restarts on a new port.

The resulting ``NetWorker.hub`` is a perfectly ordinary
:class:`~repro_torch.core.client.TensorHubClient`; every test and example that
drives the in-process client drives this one unchanged.

``device`` (the card by default; raises without one, pass ``"cpu"`` to
run on the host) is where the client's stores hold their weights, where
the data server's reads encode and checksum them, and where the
transport lands, verifies and decodes what it pulls.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.client import TensorHubClient
from repro_torch.core.errors import ServerUnavailableError, TensorHubError, TransportError
from repro_torch.net.client import AddressWatcher, RemoteClient, read_address
from repro_torch.net.data import RemoteTransport, WorkerDataServer
from repro_torch.transfer.engine import WorkerRegistry, WorkerStore, resolve_device


class _AnnouncingRegistry(WorkerRegistry):
    """A ``WorkerRegistry`` that mirrors membership into the controller's
    peer directory: ``add`` announces this worker's data address for the
    (replica, shard), ``remove`` retracts it. A briefly-unreachable
    controller is tolerated — the address watcher re-announces the full
    peer set on every failover."""

    def __init__(self, owner: "NetWorker") -> None:
        super().__init__()
        self._owner = owner

    def add(self, replica: str, shard_idx: int, store: WorkerStore) -> None:
        super().add(replica, shard_idx, store)
        try:
            self._owner.announce(replica, shard_idx)
        except (ServerUnavailableError, TensorHubError):
            pass

    def remove(self, replica: str, shard_idx: int) -> None:
        super().remove(replica, shard_idx)
        try:
            self._owner.remote().retract_peer(replica, shard_idx)
        except (ServerUnavailableError, TensorHubError):
            pass


class NetWorker:
    """A worker process's full networked stack around one hub client."""

    def __init__(
        self,
        worker_id: str,
        *,
        addr_file: Optional[str] = None,
        address: Optional[str] = None,
        heartbeat_interval: float = 0.5,
        watch_interval: float = 0.2,
        rpc_timeout: float = 10.0,
        throttle_s: float = 0.0,
        verify_checksums: bool = True,
        device="cuda",
        **client_kw: Any,
    ) -> None:
        device = resolve_device(device)
        if address is None:
            if addr_file is None:
                raise ValueError("need addr_file or address")
            deadline = time.monotonic() + rpc_timeout
            while (address := read_address(addr_file)) is None:
                if time.monotonic() >= deadline:
                    raise ServerUnavailableError(
                        f"no controller address in {addr_file!r}"
                    )
                time.sleep(0.05)
        self.worker_id = worker_id
        self.addr_file = addr_file
        self.registry = _AnnouncingRegistry(self)
        self.data_server = WorkerDataServer(self.registry, device=device).start()
        self.transport = RemoteTransport(
            self.registry,
            self._resolve,
            timeout=rpc_timeout,
            throttle_s=throttle_s,
            verify_checksums=verify_checksums,
            device=device,
        )
        self.hub = TensorHubClient(
            RemoteClient(address, timeout=rpc_timeout),
            registry=self.registry,
            transport=self.transport,
            clock=time.time,  # wall clock: shared axis with the controller
            device=device,
            **client_kw,
        )
        self.hub.start_heartbeats(heartbeat_interval)
        #: positive resolve cache: peer data addresses are stable for a
        #: worker's lifetime, and caching keeps the data plane off the
        #: controller mid-pull (a parked control plane then cannot stall
        #: an already-planned transfer's reads)
        self._peer_cache: Dict[Tuple[str, int], str] = {}
        self._cache_lock = threading.Lock()
        self.watcher: Optional[AddressWatcher] = None
        if addr_file is not None:
            self.watcher = AddressWatcher(
                self.hub,
                addr_file,
                poll_interval=watch_interval,
                peers=self._peer_list,
                timeout=rpc_timeout,
            ).start()

    # -- directory plumbing ----------------------------------------------------

    def remote(self) -> RemoteClient:
        """The hub's *current* controller proxy (changes on failover)."""
        return self.hub.server  # type: ignore[return-value]

    def announce(self, replica: str, shard_idx: int) -> None:
        self.remote().announce_peer(
            self.worker_id, replica, shard_idx, self.data_server.address
        )

    def _peer_list(self):
        return [
            (self.worker_id, replica, shard_idx, self.data_server.address)
            for (replica, shard_idx) in list(self.registry._stores)
        ]

    def _resolve(self, replica: str, shard_idx: int) -> Optional[str]:
        key = (replica, shard_idx)
        with self._cache_lock:
            cached = self._peer_cache.get(key)
        if cached is not None:
            return cached
        try:
            addr = self.remote().peer_addr(replica, shard_idx)
        except ServerUnavailableError as e:
            # directory briefly unreachable ≠ source dead: transient, the
            # engine's retry policy rides it out until failover completes
            raise TransportError(str(e), transient=True) from None
        if addr is not None:
            with self._cache_lock:
                self._peer_cache[key] = addr
        return addr

    # -- lifecycle -------------------------------------------------------------

    def open(self, *args: Any, **kw: Any):
        return self.hub.open(*args, **kw)

    def close(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        self.hub.stop_heartbeats()
        self.data_server.shutdown()
        try:
            self.remote().close()
        except Exception:
            pass


__all__ = ["NetWorker"]
