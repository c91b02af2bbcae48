"""Controller process entry point: ``python -m repro_torch.net.controller``.

Runs one WAL-backed :class:`~repro_torch.core.server.ReferenceServer` behind
the HTTP control plane. On a fresh WAL the server starts empty and
writes its config header; when the WAL already carries history (the
process was SIGKILLed and restarted — possibly on a new port), recovery
replays it into a bit-identical server *first* and only then opens the
socket, so no client ever observes a half-recovered controller.

The controller publishes its address two ways: an atomically-replaced
address file (what workers' :class:`~repro_torch.net.client.AddressWatcher`
polls to find a restarted controller) and a ``READY <host:port>`` line
on stdout (what the test harness waits for).

Host only: the controller holds no tensors and needs no device. It
moves manifests and assignments, never weight bytes, so it initializes
no CUDA context and runs the same on a machine without a card; the
workers' data servers are what run on the card.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Optional

from repro_torch.core.failover import recover
from repro_torch.core.oplog import OpLog
from repro_torch.core.server import ReferenceServer
from repro_torch.net.client import write_address
from repro_torch.net.httpd import ControlServer
from repro_torch.net.service import ReferenceService


def build_server(
    wal: Optional[str], *, group_commit: int = 1, heartbeat_timeout: Optional[float]
) -> ReferenceServer:
    """Fresh server, or a WAL replay when ``wal`` carries history."""
    if wal is None:
        return ReferenceServer(heartbeat_timeout=heartbeat_timeout)
    log = OpLog.open_path(wal, group_commit=group_commit)
    if log.config is not None:
        # restart: the config header pins the knobs; CLI ones are ignored
        return recover(log)
    return ReferenceServer(heartbeat_timeout=heartbeat_timeout, log=log)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="TensorHub networked controller")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="0 picks a free port")
    p.add_argument("--addr-file", default=None,
                   help="publish host:port here (atomic replace)")
    p.add_argument("--wal", default=None,
                   help="op-log path; restarts recover from it")
    p.add_argument("--group-commit", type=int, default=1)
    p.add_argument("--heartbeat-timeout", type=float, default=None,
                   help="seconds without a shard heartbeat before eviction")
    p.add_argument("--tick-interval", type=float, default=0.25,
                   help="heartbeat-expiry sweep period (seconds)")
    args = p.parse_args(argv)

    server = build_server(
        args.wal,
        group_commit=args.group_commit,
        heartbeat_timeout=args.heartbeat_timeout,
    )
    service = ReferenceService(server, tick_interval=args.tick_interval)
    http = ControlServer(service, host=args.host, port=args.port).start()
    if args.addr_file:
        write_address(args.addr_file, http.address)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())

    # the harness sentinel: everything before this line may be slow
    # (recovery of a long WAL), everything after is served
    print(f"READY {http.address}", flush=True)
    stop.wait()

    http.shutdown()
    if server.log is not None:
        server.log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
