"""Per-RPC latency accounting for the networked control plane.

The in-process client times its server calls through the telemetry
recorder (``CTR_CONTROL``); the networked service needs the same
visibility *per op* and server-side — which ops dominate, how long they
take, how many fail — without the recorder's span machinery. ``RpcStats``
is a tiny thread-safe accumulator the :class:`repro_torch.net.service
.ReferenceService` wraps around every dispatched frame; its snapshot
rides the service's ``metrics()`` under a dedicated ``rpc`` section and
the Prometheus text exposition as ``tensorhub_rpc_*{op="..."}`` series.

Latencies are wall-clock and therefore live outside the replayed
counter-equality contract (same rule as the server's ``gauges`` section);
call *counts* are transport-level facts (retries count twice — that is
the point) and are not expected to match between a server and its
crash-recovered twin either.
"""

from __future__ import annotations

import threading
from typing import Dict


class RpcStats:
    """Thread-safe per-op RPC counters: calls, errors, total/max latency."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._errors: Dict[str, int] = {}
        self._total_s: Dict[str, float] = {}
        self._max_s: Dict[str, float] = {}

    def record(self, op: str, seconds: float, *, ok: bool = True) -> None:
        with self._lock:
            self._calls[op] = self._calls.get(op, 0) + 1
            if not ok:
                self._errors[op] = self._errors.get(op, 0) + 1
            self._total_s[op] = self._total_s.get(op, 0.0) + seconds
            if seconds > self._max_s.get(op, 0.0):
                self._max_s[op] = seconds

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{op: {calls, errors, total_s, max_s, mean_us}}``."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for op, calls in self._calls.items():
                total = self._total_s.get(op, 0.0)
                out[op] = {
                    "calls": float(calls),
                    "errors": float(self._errors.get(op, 0)),
                    "total_s": total,
                    "max_s": self._max_s.get(op, 0.0),
                    "mean_us": (total / calls) * 1e6 if calls else 0.0,
                }
            return out

    def text(self) -> str:
        """Prometheus-style exposition lines (labelled by op), matching
        the server's ``metrics_text`` framing so the two concatenate into
        one scrape body."""
        snap = self.snapshot()
        lines = []
        for metric, ptype in (
            ("rpc_calls_total", "counter"),
            ("rpc_errors_total", "counter"),
            ("rpc_latency_seconds_total", "counter"),
            ("rpc_latency_seconds_max", "gauge"),
        ):
            lines.append(f"# TYPE tensorhub_{metric} {ptype}")
            key = {
                "rpc_calls_total": "calls",
                "rpc_errors_total": "errors",
                "rpc_latency_seconds_total": "total_s",
                "rpc_latency_seconds_max": "max_s",
            }[metric]
            for op in sorted(snap):
                val = snap[op][key]
                text = f"{val:.9f}".rstrip("0").rstrip(".") if val % 1 else str(int(val))
                lines.append(f'tensorhub_{metric}{{op="{op}"}} {text}')
        return "\n".join(lines) + "\n"


__all__ = ["RpcStats"]
