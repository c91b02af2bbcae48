"""Low-overhead telemetry recorder: spans, counters, histograms.

The recorder is clock-injected: pass ``time.monotonic`` (default) for
the threaded data plane or ``lambda: env.now`` for the simulator, and
the same instrumentation code produces wall-clock or virtual-time
spans with no other changes.

Design constraints (the update path must stay within 2% of the
uninstrumented baseline, and the *disabled* path must allocate
nothing):

- A disabled recorder's ``counter_add`` / ``observe`` / ``event``
  return before touching any container, and ``span()`` returns a
  shared no-op context-manager singleton. Hot call sites additionally
  guard with ``if rec.enabled:`` so keyword-argument dicts are never
  built on the disabled path.
- Finished spans are stored as flat tuples ``(name, track, t0, t1,
  parent, attrs)`` appended to one list — no per-span objects survive
  beyond their lifetime.
- A single lock guards the containers; it is only taken when enabled.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# Canonical decomposition of destination stall time. Every benchmark
# reports these five components; they must (approximately) tile the
# end-to-end stall.
STALL_COMPONENTS = ("plan_wait", "wire", "decode", "verify", "control")

# Counter names the data planes feed and stall_breakdown() reads.
CTR_PLAN_WAIT = "stall/plan_wait"
CTR_WIRE = "stall/wire"  # gross time around transport calls
CTR_DECODE = "stall/decode"
CTR_VERIFY = "stall/verify"
CTR_CONTROL = "stall/control"

# Gray-failure self-healing counters (event counts, not seconds): each
# increment pairs with a span event of the same name carrying the
# source/unit involved.
CTR_RETRIES = "heal/retries"
CTR_HEDGES = "heal/hedges"
CTR_CORRUPT_REJECTS = "heal/corrupt_rejects"
CTR_DEADLINE_REPORTS = "heal/deadline_reports"

# Delta-transfer fallbacks: a delta frame met a stale/evicted base at
# the destination and the unit was transparently re-shipped through the
# base codec (event count; pairs with a "delta_stale_fallback" event).
CTR_DELTA_STALE = "heal/delta_stale_fallbacks"

# Networked data plane: reads served over a re-used keep-alive
# connection from the per-peer pool (event count; the complement of
# fresh TCP connects, which pay handshake + slow-start).
CTR_CONN_REUSE = "net/conn_reuses"


class _NullSpan:
    """Shared no-op span; returned by a disabled recorder."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def end(self) -> None:
        return None


NULL_SPAN = _NullSpan()


class Span:
    """An open span. Close with ``end()`` or use as a context manager.

    Spans nest per ``track``: a span opened while another span on the
    same track is open records that span's name as its ``parent``.
    """

    __slots__ = ("_rec", "name", "track", "t0", "parent", "attrs")

    def __init__(self, rec: "Recorder", name: str, track: str,
                 t0: float, parent: Optional[str], attrs: Optional[dict]):
        self._rec = rec
        self.name = name
        self.track = track
        self.t0 = t0
        self.parent = parent
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def end(self) -> None:
        rec = self._rec
        if rec is None:
            return
        self._rec = None
        rec._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class Recorder:
    """Collects spans, counters and histograms under an injected clock."""

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 enabled: bool = True):
        self.clock = clock
        self.enabled = enabled
        # Finished spans: (name, track, t0, t1, parent, attrs-or-None).
        self.events: List[Tuple[str, str, float, float, Optional[str], Optional[dict]]] = []
        self.counters: Dict[str, float] = {}
        self.histograms: Dict[str, List[float]] = {}
        self._lock = threading.Lock()
        # Open-span stacks keyed by track (for parent attribution).
        self._open: Dict[str, List[Span]] = {}

    # -- spans ---------------------------------------------------------

    def span(self, name: str, track: str = "main", **attrs):
        """Open a span; returns a context manager with an ``end()``."""
        if not self.enabled:
            return NULL_SPAN
        t0 = self.clock()
        with self._lock:
            stack = self._open.get(track)
            parent = stack[-1].name if stack else None
            sp = Span(self, name, track, t0, parent, attrs or None)
            if stack is None:
                self._open[track] = [sp]
            else:
                stack.append(sp)
        return sp

    def _finish(self, sp: Span) -> None:
        t1 = self.clock()
        with self._lock:
            stack = self._open.get(sp.track)
            if stack is not None and sp in stack:
                stack.remove(sp)
            self.events.append((sp.name, sp.track, sp.t0, t1, sp.parent, sp.attrs))

    def event(self, name: str, track: str = "main", **attrs) -> None:
        """Record an instantaneous (zero-duration) event."""
        if not self.enabled:
            return
        now = self.clock()
        with self._lock:
            stack = self._open.get(track)
            parent = stack[-1].name if stack else None
            self.events.append((name, track, now, now, parent, attrs or None))

    # -- counters / histograms ----------------------------------------

    def counter_add(self, name: str, value: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def observe(self, name: str, value: float) -> None:
        """Record one histogram sample."""
        if not self.enabled:
            return
        with self._lock:
            samples = self.histograms.get(name)
            if samples is None:
                self.histograms[name] = [value]
            else:
                samples.append(value)

    def histogram_summary(self, name: str) -> Dict[str, float]:
        samples = sorted(self.histograms.get(name, ()))
        if not samples:
            return {"count": 0, "sum": 0.0, "min": 0.0, "p50": 0.0, "max": 0.0}
        n = len(samples)
        return {
            "count": n,
            "sum": sum(samples),
            "min": samples[0],
            "p50": samples[n // 2],
            "max": samples[-1],
        }

    # -- lifecycle -----------------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.counters.clear()
            self.histograms.clear()
            self._open.clear()

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time copy of counters and histogram summaries."""
        with self._lock:
            counters = dict(self.counters)
            hist_names = list(self.histograms)
        return {
            "counters": counters,
            "histograms": {n: self.histogram_summary(n) for n in hist_names},
            "spans": len(self.events),
        }


#: Shared disabled recorder, used as the default everywhere a recorder
#: is optional. Never enable this instance — create your own instead.
DISABLED = Recorder(enabled=False)


def stall_breakdown(recorder: Recorder) -> Dict[str, float]:
    """Destination stall decomposition from a recorder's counters.

    ``stall/wire`` is gross time around transport calls; decode and
    checksum-verify time measured inside the transport is carved out
    of it so the five components tile rather than double-count.
    """
    c = recorder.counters
    decode = c.get(CTR_DECODE, 0.0)
    verify = c.get(CTR_VERIFY, 0.0)
    gross = c.get(CTR_WIRE, 0.0)
    return {
        "plan_wait": c.get(CTR_PLAN_WAIT, 0.0),
        "wire": max(0.0, gross - decode - verify),
        "decode": decode,
        "verify": verify,
        "control": c.get(CTR_CONTROL, 0.0),
    }
