"""HTTP transport for the control plane.

The thinnest possible shim over :meth:`ReferenceService.handle_frame`:
one ``POST /rpc`` endpoint moving opaque frames, plus ``GET /metrics``
(Prometheus text exposition) and ``GET /healthz`` for scrapers and
process supervisors. HTTP/1.1 keep-alive lets a ``RemoteClient`` reuse
one connection for its whole op stream; ``ThreadingHTTPServer`` gives a
thread per connection and the service's lock restores the server's
single-threaded semantics behind them.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

from repro_torch.net.service import ReferenceService

#: sanity cap on frame size; control-plane frames are manifests at most
#: (a few MB), so anything larger is a protocol violation, not a payload
MAX_FRAME_BYTES = 64 * 1024 * 1024


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: one connection per client
    server_version = "tensorhub-control/1"
    # request/response frames are small and latency-bound: buffer the
    # response into one segment and disable Nagle, or the unbuffered
    # header/body writes interact with delayed ACK into ~40ms per RPC
    wbufsize = -1
    disable_nagle_algorithm = True

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        pass  # stderr chatter would drown subprocess-test log tails

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/rpc":
            self._send(404, b"not found", "text/plain")
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = -1
        if length < 0 or length > MAX_FRAME_BYTES:
            self._send(413, b"bad frame length", "text/plain")
            return
        data = self.rfile.read(length)
        # handle_frame is total: any malformation comes back as a clean
        # error frame, so a fuzzer never sees a dropped connection
        out = self.server.service.handle_frame(data)  # type: ignore[attr-defined]
        self._send(200, out, "application/json")

    def do_GET(self) -> None:  # noqa: N802
        service: ReferenceService = self.server.service  # type: ignore[attr-defined]
        if self.path == "/healthz":
            self._send(200, b"ok\n", "text/plain")
        elif self.path == "/metrics":
            body = service.metrics_text().encode("utf-8")
            self._send(200, body, "text/plain; version=0.0.4")
        else:
            self._send(404, b"not found", "text/plain")


class ControlServer:
    """Serve a :class:`ReferenceService` over HTTP on ``host:port``
    (port 0 picks a free one). ``start()`` runs the accept loop on a
    daemon thread; ``shutdown()`` stops it and closes the socket."""

    def __init__(
        self, service: ReferenceService, host: str = "127.0.0.1", port: int = 0
    ) -> None:
        self.service = service
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.service = service  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "ControlServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="tensorhub-control-http",
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
        self.service.stop()


def split_address(address: str) -> Tuple[str, int]:
    """``"host:port"`` → ``(host, port)``; raises ValueError when malformed."""
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad address {address!r}")
    return host, int(port)


__all__ = ["ControlServer", "MAX_FRAME_BYTES", "split_address"]
