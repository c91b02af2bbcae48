"""Socketed data plane: remote worker-to-worker byte movement.

``WorkerDataServer`` exposes one worker's registered stores over HTTP —
the reproduction's stand-in for the paper's one-sided RDMA reads. A
request names what to read (whole unit, or a row-grid-aligned chunk —
resharded interval reads arrive as widened unit chunks since the
row-grid planner) plus the negotiated codec; the response body is the
**wire frame** (codec-encoded at the source, exactly the bytes the NIC
would carry) and the ``X-TH-Checksum`` header carries the source's
read-time checksum over the *decoded* payload (over the wire frame
itself for ``raw_wire`` requests, where the caller decodes) — the same
end-to-end transit contract as
:class:`~repro_torch.transfer.engine.LocalTransport`, with the verification
halves now genuinely on opposite ends of a socket.

The bytes stay where they live until the socket: a read slices the unit
on the source store's device and encodes and checksums it there (the
quant and checksum kernels on the card); only the finished wire frame,
as a flat ``uint8`` view, is copied to the host to be sent. The
receiving side reads the body into one host buffer, moves it to the
destination store's device once, and verifies, decodes and writes it
there. Device work in the server's handler threads and the client's
pull threads runs under ``torch.cuda.device`` of the store it touches:
the kernels launch on the calling thread's current device.

``RemoteTransport`` extends ``LocalTransport``: a source that is
registered in this process is read through the inherited in-memory path,
anything else resolves to a peer address (via the controller's announce
directory) and is pulled over HTTP/1.1 keep-alive connections pooled per
``(host, port)`` — a windowed pull re-uses a handful of warm sockets
instead of paying connect + slow-start per read. Delta frames keep their
fallback semantics — the *destination* decodes against its own held
base, and a stale base triggers one re-request with ``no_base`` set,
mirroring the in-process transparent re-ship (both frames are accounted
as wire bytes).
"""

from __future__ import annotations

import contextlib
import http.client
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Callable

import torch

from repro_torch.core.errors import (
    ChecksumError,
    TensorHubError,
    TransportError,
)
from repro_torch.core.meta import TransferUnit, from_wire, to_wire
from repro_torch.net import protocol
from repro_torch.net.httpd import split_address
from repro_torch.obs import telemetry as obs
from repro_torch.transfer import checksum as checksum_lib
from repro_torch.transfer import codec as codec_lib
from repro_torch.transfer.engine import (
    LocalTransport,
    WorkerRegistry,
    WorkerStore,
    resolve_device,
)

# codec failures must re-raise as themselves across the wire: the engine
# distinguishes CodecError (decode-failure healing) from ChecksumError
# (corruption evidence), and StaleBaseError drives the delta fallback
protocol.register_error(codec_lib.CodecError)
protocol.register_error(codec_lib.StaleBaseError)

DATA_PROTOCOL_VERSION = 1

_NET_ERRORS = (ConnectionError, socket.timeout, http.client.HTTPException, OSError)


def on_device(device: torch.device):
    """Make ``device`` the calling thread's current card for the kernels
    launched inside (a no-op for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def host_bytes(t: torch.Tensor) -> memoryview:
    """A flat byte tensor's bytes on the host, for the socket: one copy
    off the card (none for a contiguous CPU tensor), never through a
    numpy view of the element dtype (bfloat16 has none)."""
    return memoryview(codec_lib.as_bytes(t).cpu().numpy())


# ---------------------------------------------------------------------------
# serving side
# ---------------------------------------------------------------------------


def _serve_read(registry: WorkerRegistry, req: Dict[str, Any]) -> tuple:
    """Execute one read request against the local registry.

    Returns ``(wire_bytes, checksum)`` where the checksum is folded over
    the decoded payload — or over the wire frame itself for ``raw_wire``
    requests, which the caller decodes (0 when verification is off — the
    disabled sentinel the checksum module reserves). The encode and both
    checksums run on the source store's device; ``wire_bytes`` is the
    host copy of the finished frame. Raises typed errors; the handler
    encodes them for the wire."""
    if req.get("v") != DATA_PROTOCOL_VERSION:
        raise protocol.ProtocolError(
            f"unsupported data protocol version {req.get('v')!r}"
        )
    kind = req.get("kind")
    replica = req["replica"]
    shard_idx = int(req["shard_idx"])
    codec = req.get("codec", "raw")
    verify = bool(req.get("verify", True))
    src = registry.get(replica, shard_idx)

    unit: TransferUnit = from_wire(req["unit"])
    with on_device(src.device):
        full = src.read_unit(unit)
        if kind == "chunk":
            offset, nbytes = int(req["offset"]), int(req["nbytes"])
            if nbytes < 0 or offset < 0 or offset + nbytes > full.nbytes:
                raise TensorHubError(
                    f"unit {unit.name}: chunk [{offset}, {offset + nbytes}) "
                    f"exceeds unit of {full.nbytes}B"
                )
            view = full[offset : offset + nbytes]
        elif kind == "unit":
            offset, nbytes = 0, full.nbytes
            view = full
        else:
            raise protocol.ProtocolError(f"unknown data request kind {kind!r}")

        if codec == "raw":
            return host_bytes(view), (checksum_lib.checksum(view) if verify else 0)

        cdc = codec_lib.get_codec(codec)
        dtype = src.unit_dtype(unit)
        if kind == "chunk":
            rb = cdc.row_bytes(dtype)
            if offset % rb or (nbytes % rb and offset + nbytes != full.nbytes):
                raise codec_lib.CodecError(
                    f"chunk {unit.name}[{offset}:{offset + nbytes}] not aligned "
                    f"to the {codec} codec's {rb}B row granularity — the "
                    "reassembled unit would diverge from an unchunked transfer"
                )
        if req.get("raw_wire", False):
            # the caller decodes (fused dequant+gather at the destination):
            # ship the frame and checksum the frame itself
            if getattr(cdc, "needs_base", False):
                raise codec_lib.CodecError(
                    f"wire-frame reads cannot carry the base-referencing codec "
                    f"{codec!r} (no destination base at frame granularity) — "
                    "resolve the reshard codec first"
                )
            wire = cdc.encode(view, dtype)
            return host_bytes(wire), (checksum_lib.checksum(wire) if verify else 0)
        if getattr(cdc, "needs_base", False) and not req.get("no_base", False):
            base_full = src.base_unit(unit)
            base = (
                None
                if base_full is None
                else (base_full[offset : offset + nbytes] if kind == "chunk" else base_full)
            )
            wire = cdc.encode(view, dtype, base=base)
            # checksum over the decode against the SAME base the frame was
            # encoded against — the base codec's round trip of the snapshot,
            # which is what the destination holds: any destination whose
            # decode succeeds (its base digest matched) reconstructs these
            # exact bytes. (Decoding against the raw snapshot would fail the
            # frame's digest check for delta:int8.)
            held = None if base is None else cdc._base_estimate(base, dtype)  # noqa: SLF001
            csum = checksum_lib.checksum(cdc.decode(wire, base=held)) if verify else 0
        else:
            wire = cdc.encode(view, dtype)
            csum = checksum_lib.checksum(cdc.decode(wire)) if verify else 0
        return host_bytes(wire), csum


class _DataHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "tensorhub-data/1"
    # buffer the response and disable Nagle: unbuffered header writes
    # plus delayed ACK otherwise cost ~40ms of idle per request
    wbufsize = -1
    disable_nagle_algorithm = True

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        pass

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/data":
            self._fail(404, protocol.ProtocolError("not found"))
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length).decode("utf-8"))
            if not isinstance(req, dict):
                raise protocol.ProtocolError("data request must be an object")
            body, csum = _serve_read(self.server.registry, req)  # type: ignore[attr-defined]
        except (TensorHubError, KeyError, ValueError, TypeError) as e:
            self._fail(500, e)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-TH-Checksum", str(csum))
        self.end_headers()
        self.wfile.write(body)

    def _fail(self, status: int, exc: BaseException) -> None:
        err: Dict[str, Any] = {"kind": type(exc).__name__, "message": str(exc)}
        if isinstance(exc, TransportError):
            err["transient"] = bool(exc.transient)
        body = json.dumps(err).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class WorkerDataServer:
    """Serve this process's :class:`WorkerRegistry` over HTTP.

    ``device`` is where its stores live: ``"cuda"`` (the default) raises
    without a card, ``"cpu"`` serves host stores. Each read runs on its
    own store's device (a worker's CPU offload store included)."""

    def __init__(
        self,
        registry: WorkerRegistry,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        device="cuda",
    ) -> None:
        self.registry = registry
        self.device = resolve_device(device)
        self._httpd = ThreadingHTTPServer((host, port), _DataHandler)
        self._httpd.daemon_threads = True
        self._httpd.registry = registry  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "WorkerDataServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="tensorhub-data-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# ---------------------------------------------------------------------------
# pulling side
# ---------------------------------------------------------------------------


def _read_body(resp: http.client.HTTPResponse) -> bytearray:
    """The response body in one writable host buffer: read straight into
    a buffer of the announced length (the one host copy a pull makes
    before its copy to the device)."""
    length = resp.length
    if length is None:
        return bytearray(resp.read())
    buf = bytearray(length)
    view = memoryview(buf)
    got = 0
    while got < length:
        n = resp.readinto(view[got:])
        if not n:
            raise http.client.IncompleteRead(bytes(view[:got]), length - got)
        got += n
    return buf


class RemoteTransport(LocalTransport):
    """A ``LocalTransport`` whose reads may cross the network.

    ``resolve(replica, shard_idx)`` maps a source the local registry does
    not hold to a peer data-server address (the controller's announce
    directory, via :meth:`RemoteClient.peer_addr`). An unresolved peer is
    a *transient* transport fault — after a controller restart the
    directory refills as workers re-announce, and the engine's retry
    policy rides through the race.

    A remote body lands on the destination store's device (``pull_unit``)
    or on ``device`` (``read_unit_range``; this transport's ``device``
    when the caller names none), where it is verified and decoded.
    """

    def __init__(
        self,
        registry: WorkerRegistry,
        resolve: Callable[[str, int], Optional[str]],
        *,
        timeout: float = 30.0,
        throttle_s: float = 0.0,
        pool_size: int = 4,
        device="cuda",
        **kw: Any,
    ) -> None:
        super().__init__(registry, **kw)
        self.device = resolve_device(device)
        self.resolve = resolve
        self.timeout = timeout
        #: test knob: stretch every remote unit pull so a subprocess test
        #: can land a controller SIGKILL mid-pull deterministically
        self.throttle_s = throttle_s
        self.remote_pulls = 0
        #: idle keep-alive connections retained per (host, port)
        self.pool_size = pool_size
        self._pool: Dict[tuple, list] = {}
        self._pool_lock = threading.Lock()
        self.conn_opens = 0
        self.conn_reuses = 0

    # -- plumbing --------------------------------------------------------------

    def _is_local(self, replica: str, shard_idx: int) -> bool:
        return self.registry.lookup(replica, shard_idx) is not None

    def _open_conn(self, host: str, port: int) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(host, port, timeout=self.timeout)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._acct_lock:
            self.conn_opens += 1
        return conn

    def _checkout(self, host: str, port: int) -> tuple:
        """A connection to the peer: pooled keep-alive if one is idle
        (returns ``(conn, True)``), else a fresh connect."""
        with self._pool_lock:
            idle = self._pool.get((host, port))
            if idle:
                return idle.pop(), True
        return self._open_conn(host, port), False

    def _checkin(self, host: str, port: int, conn: http.client.HTTPConnection) -> None:
        with self._pool_lock:
            idle = self._pool.setdefault((host, port), [])
            if len(idle) < self.pool_size:
                idle.append(conn)
                return
        conn.close()

    def close_pool(self) -> None:
        """Drop every idle pooled connection (tests; graceful teardown)."""
        with self._pool_lock:
            pools, self._pool = list(self._pool.values()), {}
        for idle in pools:
            for conn in idle:
                conn.close()

    def _fetch(
        self, replica: str, shard_idx: int, req: Dict[str, Any], device: torch.device
    ) -> tuple:
        """POST one read request to the peer serving ``replica/shard``;
        returns ``(payload, source_checksum)``, the payload a flat uint8
        tensor on ``device``.

        Connections are pooled per (host, port): HTTP/1.1 keep-alive lets
        a windowed pull re-use a handful of warm sockets instead of
        paying connect + slow-start per read. A pooled socket may have
        gone stale (peer restarted, idle timeout); a send/recv failure on
        a *re-used* connection retries once on a fresh connect before
        surfacing a transient fault."""
        addr = self.resolve(replica, shard_idx)
        if addr is None:
            raise TransportError(
                f"no announced data peer for {replica}/shard{shard_idx}",
                transient=True,
            )
        host, port = split_address(addr)
        body = json.dumps(
            {"v": DATA_PROTOCOL_VERSION, "replica": replica,
             "shard_idx": shard_idx, "verify": self.verify_checksums, **req}
        ).encode("utf-8")
        for attempt in (0, 1):
            try:
                if attempt == 0:
                    conn, reused = self._checkout(host, port)
                else:
                    conn, reused = self._open_conn(host, port), False
            except _NET_ERRORS as e:
                raise TransportError(
                    f"data pull from {replica}/shard{shard_idx} ({addr}) "
                    f"failed: {e}",
                    transient=True,
                ) from None
            try:
                conn.request(
                    "POST", "/data", body=body,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                payload = _read_body(resp)
            except _NET_ERRORS as e:
                conn.close()
                if reused:
                    continue  # stale keep-alive socket: one fresh retry
                raise TransportError(
                    f"data pull from {replica}/shard{shard_idx} ({addr}) "
                    f"failed: {e}",
                    transient=True,
                ) from None
            if reused:
                with self._acct_lock:
                    self.conn_reuses += 1
                rec = self.recorder
                if rec.enabled:
                    rec.counter_add(obs.CTR_CONN_REUSE, 1)
            if resp.will_close:
                conn.close()
            else:
                self._checkin(host, port, conn)
            if resp.status != 200:
                try:
                    err = json.loads(payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    err = {"kind": "TransportError", "message": payload[:200].decode("utf-8", "replace"), "transient": True}
                protocol.raise_from_error(err)
            csum = int(resp.getheader("X-TH-Checksum", "0"))
            # the body's one copy to the device (none for a CPU destination)
            if not payload:  # a zero-length tail chunk
                return torch.empty(0, dtype=torch.uint8, device=device), csum
            return torch.frombuffer(payload, dtype=torch.uint8).to(device), csum
        raise AssertionError("unreachable")  # pragma: no cover

    @staticmethod
    def _verify(payload: torch.Tensor, expected: int, what: str) -> None:
        got = checksum_lib.checksum(payload)
        if got != expected:
            raise ChecksumError(
                f"{what}: checksum {got:#x} != expected {expected:#x}"
            )

    # -- transport interface ---------------------------------------------------

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
        if self._is_local(src_replica, shard_idx):
            super().pull_unit(
                src_replica, shard_idx, unit, expected_checksum,
                dst_store, codec, link_class, track,
            )
            return
        self._fault_read(src_replica, shard_idx)
        if self.throttle_s:
            time.sleep(self.throttle_s)
        with self._acct_lock:
            self.remote_pulls += 1
        dev = dst_store.device
        req = {"kind": "unit", "unit": to_wire(unit), "codec": codec}
        with on_device(dev):
            payload, src_csum = self._fetch(src_replica, shard_idx, req, dev)
            cdc = codec_lib.get_codec(codec)
            if codec == "raw":
                if self.verify_checksums and expected_checksum:
                    self._verify(
                        payload, expected_checksum,
                        f"unit {unit.name} from {src_replica}/shard{shard_idx}",
                    )
                dst_store.write_unit(unit, payload)
                self._account(link_class, unit.nbytes, unit.nbytes)
                return
            wire = payload
            wire_nbytes = wire.nbytes
            if getattr(cdc, "needs_base", False):
                try:
                    payload = cdc.decode(wire, base=self._dest_base(dst_store, unit))
                except codec_lib.StaleBaseError:
                    # the destination's base diverged from the source's — same
                    # transparent re-ship as in-process, one extra round trip
                    with self._acct_lock:
                        self.delta_stale_fallbacks += 1
                    wire, src_csum = self._fetch(
                        src_replica, shard_idx, {**req, "no_base": True}, dev
                    )
                    wire_nbytes += wire.nbytes
                    payload = cdc.decode(wire)
            else:
                payload = cdc.decode(wire)
            if self.verify_checksums:
                self._verify(
                    payload, src_csum,
                    f"unit {unit.name} ({codec}) from {src_replica}/shard{shard_idx}",
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
        if self._is_local(src_replica, shard_idx):
            return super().read_unit_range(
                src_replica, shard_idx, unit, offset, nbytes,
                codec, link_class, dest_base, decode, device,
            )
        self._fault_read(src_replica, shard_idx)
        if self.throttle_s:
            time.sleep(self.throttle_s)
        dev = self.device if device is None else device
        req = {
            "kind": "chunk", "unit": to_wire(unit), "codec": codec,
            "offset": int(offset), "nbytes": int(nbytes),
        }
        if not decode and codec != "raw":
            if getattr(codec_lib.get_codec(codec), "needs_base", False):
                raise codec_lib.CodecError(
                    f"wire-frame reads cannot carry the base-referencing "
                    f"codec {codec!r} (no destination base at frame "
                    "granularity) — resolve the reshard codec first"
                )
            with on_device(dev):
                payload, src_csum = self._fetch(
                    src_replica, shard_idx, {**req, "raw_wire": True}, dev
                )
                if self.verify_checksums:
                    self._verify(
                        payload, src_csum,
                        f"chunk {unit.name}[{offset}:{offset + nbytes}] "
                        f"({codec} wire) from {src_replica}/shard{shard_idx}",
                    )
            self._account(link_class, payload.nbytes, nbytes)
            return payload
        with on_device(dev):
            payload, src_csum = self._fetch(src_replica, shard_idx, req, dev)
            if codec == "raw":
                if self.verify_checksums:
                    self._verify(
                        payload, src_csum,
                        f"chunk {unit.name}[{offset}:{offset + nbytes}] from "
                        f"{src_replica}/shard{shard_idx}",
                    )
                self._account(link_class, nbytes, nbytes)
                return payload
            cdc = codec_lib.get_codec(codec)
            wire = payload
            wire_nbytes = wire.nbytes
            if getattr(cdc, "needs_base", False):
                try:
                    payload = cdc.decode(wire, base=dest_base)
                except codec_lib.StaleBaseError:
                    with self._acct_lock:
                        self.delta_stale_fallbacks += 1
                    wire, src_csum = self._fetch(
                        src_replica, shard_idx, {**req, "no_base": True}, dev
                    )
                    wire_nbytes += wire.nbytes
                    payload = cdc.decode(wire)
            else:
                payload = cdc.decode(wire)
            if self.verify_checksums:
                self._verify(
                    payload, src_csum,
                    f"chunk {unit.name}[{offset}:{offset + nbytes}] ({codec}) from "
                    f"{src_replica}/shard{shard_idx}",
                )
        self._account(link_class, wire_nbytes, nbytes)
        return payload

__all__ = [
    "DATA_PROTOCOL_VERSION",
    "RemoteTransport",
    "WorkerDataServer",
]
