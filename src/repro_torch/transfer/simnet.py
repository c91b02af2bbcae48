"""Discrete-event network simulator with max-min fair bandwidth sharing.

The container has one CPU and no RNIC, so the paper's *timing* behaviour is
reproduced with a calibrated fluid-flow model: each transfer is a flow over
a set of unidirectional links (full-duplex NICs are two links); active flows
share every link max-min fairly (progressive filling), which naturally
produces the contention effects the paper measures — e.g. the quadratic
stall growth of single-rooted fan-out in Fig 7b vs the linear growth with
pipeline replication.

The *control plane* driven on top of this simulator is the real
``ReferenceServer`` — identical code to the threaded client path.

Processes are Python generators that yield:

* ``env.timeout(dt)``   — resume after dt seconds of virtual time
* ``SimEvent``          — resume when the event fires (``ev.succeed()``)
* ``network.flow(...)`` — resume when the flow completes (raises
  ``FlowKilled`` into the generator if a link endpoint died)

Determinism: the event heap is ordered by (time, seq); no wall-clock or
randomness enters unless a benchmark injects a seeded RNG.
"""

from __future__ import annotations

import heapq
import itertools
import math
from typing import Callable, Dict, Generator, Iterable, List, Optional, Tuple

Process = Generator


class FlowKilled(Exception):
    """The flow's src/dst vanished; delivered after the detection delay.

    ``transient`` marks an injected gray failure (flaky read): the
    endpoint is still alive and a retry is expected to succeed, so the
    reader backs off and re-issues instead of reporting a dead source.
    """

    def __init__(self, tag: str = "", transient: bool = False) -> None:
        super().__init__(tag)
        self.tag = tag
        self.transient = transient


class SimEvent:
    """One-shot event; processes may wait on it, it may carry a value."""

    __slots__ = ("env", "_done", "_value", "_error", "_waiters", "_callbacks")

    def __init__(self, env: "SimEnv") -> None:
        self.env = env
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None
        self._waiters: List[Process] = []
        self._callbacks: List[Callable[["SimEvent"], None]] = []

    @property
    def triggered(self) -> bool:
        return self._done

    @property
    def value(self):
        return self._value

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def add_callback(self, cb: Callable[["SimEvent"], None]) -> None:
        if self._done:
            self.env.schedule(0.0, lambda: cb(self))
        else:
            self._callbacks.append(cb)

    def succeed(self, value=None) -> None:
        if self._done:
            return
        self._done = True
        self._value = value
        for p in self._waiters:
            self.env._resume(p, value=value)
        self._waiters.clear()
        for cb in self._callbacks:
            cb(self)
        self._callbacks.clear()

    def fail(self, error: BaseException) -> None:
        if self._done:
            return
        self._done = True
        self._error = error
        for p in self._waiters:
            self.env._resume(p, error=error)
        self._waiters.clear()
        for cb in self._callbacks:
            cb(self)
        self._callbacks.clear()


class SimEnv:
    """Minimal deterministic event loop (SimPy-flavoured)."""

    #: safety-net period for keyed waiters (seconds of virtual time). A
    #: keyed wait is woken spuriously after this long *only once the hard
    #: event heap has quiesced* — i.e. a missed wakeup can delay a waiter,
    #: never deadlock it, and the tick costs nothing on healthy runs
    #: (it fires after all real work, when no waiter is left pending).
    safety_tick: float = 30.0

    def __init__(self) -> None:
        self.now = 0.0
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        #: broadcast event for "server state changed" waiters; re-armed on
        #: every notify (condition-variable analogue)
        self._state_event = SimEvent(self)
        #: keyed one-shot events for targeted wakeups (e.g. per-source
        #: progress-counter advances) — avoids thundering-herd wake storms
        self._keyed: Dict[object, SimEvent] = {}
        #: next armed safety tick (None = nothing armed). Kept *out* of the
        #: hard heap so an armed-but-unneeded tick never advances ``now``.
        self._safety_at: Optional[float] = None

    # -- scheduling --------------------------------------------------------------

    def schedule(self, delay: float, cb: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (self.now + max(delay, 0.0), next(self._seq), cb))

    def timeout(self, delay: float) -> SimEvent:
        ev = SimEvent(self)
        self.schedule(delay, ev.succeed)
        return ev

    def state_wait(self) -> SimEvent:
        """Wait until the next state_notify() (server watcher bump)."""
        return self._state_event

    def state_notify(self) -> None:
        ev = self._state_event
        self._state_event = SimEvent(self)
        ev.succeed()

    def key_wait(self, key: object) -> SimEvent:
        """Wait until the next key_notify(key) (or a safety tick)."""
        ev = self._keyed.get(key)
        if ev is None:
            ev = SimEvent(self)
            self._keyed[key] = ev
        if self._safety_at is None:
            self._safety_at = self.now + self.safety_tick
        return ev

    def key_notify(self, key: object) -> None:
        ev = self._keyed.pop(key, None)
        if ev is not None:
            ev.succeed()

    def key_notify_where(self, pred: Callable[[object], bool]) -> int:
        """Fire every pending keyed event whose key matches ``pred`` —
        used by failure paths that cannot enumerate exact keys (e.g. all
        progress keys of a dying replica, whatever its shard count)."""
        hits = [k for k in self._keyed if pred(k)]
        for k in hits:
            self._keyed.pop(k).succeed()
        return len(hits)

    def _fire_safety(self) -> None:
        """Spurious-wakeup sweep: fire and drop every keyed event. Waiters
        re-check their condition and re-wait (re-arming the tick); stale
        entries nobody listens to are garbage-collected here."""
        stale = self._keyed
        self._keyed = {}
        for ev in stale.values():
            ev.succeed()

    def any_of(self, *events: SimEvent) -> SimEvent:
        """Combined event that fires when the first constituent fires."""
        out = SimEvent(self)
        for ev in events:
            ev.add_callback(
                lambda e: out.fail(e.error) if e.error is not None else out.succeed(e.value)
            )
        return out

    # -- processes ----------------------------------------------------------------

    def process(self, gen: Process) -> SimEvent:
        """Start a generator process; returns an event that fires with the
        generator's return value (or error)."""
        done = SimEvent(self)
        self.schedule(0.0, lambda: self._step(gen, done, None, None))
        return done

    def _resume(self, gen_ctx, value=None, error: Optional[BaseException] = None) -> None:
        gen, done = gen_ctx
        self.schedule(0.0, lambda: self._step(gen, done, value, error))

    def _step(self, gen: Process, done: SimEvent, value, error) -> None:
        try:
            if error is not None:
                yielded = gen.throw(error)
            else:
                yielded = gen.send(value)
        except StopIteration as stop:
            done.succeed(stop.value)
            return
        except BaseException as exc:  # propagate process crash to waiters
            done.fail(exc)
            return
        if isinstance(yielded, SimEvent):
            if yielded.triggered:
                if yielded._error is not None:
                    self._resume((gen, done), error=yielded._error)
                else:
                    self._resume((gen, done), value=yielded._value)
            else:
                yielded._waiters.append((gen, done))
        else:
            raise TypeError(f"process yielded {yielded!r}; expected SimEvent")

    # -- run ----------------------------------------------------------------------

    def run(self, until: float = math.inf) -> float:
        while True:
            while self._heap and self._heap[0][0] <= until:
                t, _, cb = heapq.heappop(self._heap)
                self.now = max(self.now, t)
                cb()
            # Hard heap quiesced: if keyed waiters are still pending, fire
            # the safety net and keep going; otherwise we are done. The
            # tick advances virtual time only in this (otherwise-deadlocked)
            # case, so healthy runs see identical timings.
            if (
                self._safety_at is not None
                and self._safety_at <= until
                and any(
                    ev._waiters or ev._callbacks for ev in self._keyed.values()
                )
            ):
                self.now = max(self.now, self._safety_at)
                self._safety_at = None
                self._fire_safety()
                continue
            break
        # disarm only when nobody is left waiting: a keyed waiter pending
        # across a finite-`until` boundary keeps its safety net for the
        # next run() call (clearing it unconditionally would deadlock a
        # missed wakeup, which the safety tick exists to prevent)
        if not any(ev._waiters or ev._callbacks for ev in self._keyed.values()):
            self._safety_at = None
        if math.isfinite(until):
            self.now = max(self.now, until)
        return self.now


# ---------------------------------------------------------------------------
# Fluid-flow network
# ---------------------------------------------------------------------------


class Link:
    """Unidirectional capacity (bytes/s). A full-duplex NIC is two links."""

    __slots__ = ("name", "capacity", "flows")

    def __init__(self, name: str, capacity: float) -> None:
        self.name = name
        self.capacity = capacity
        # insertion-ordered set: Flow hashes by id, so a real set would
        # iterate in a different order every process/run — float
        # accumulation order must be reproducible for bit-identical replay
        self.flows: Dict["Flow", None] = {}

    def __repr__(self) -> str:
        return f"Link({self.name}, {self.capacity/1e9:.1f} GB/s, {len(self.flows)} flows)"


class Flow:
    __slots__ = (
        "nbytes", "links", "rate_cap", "remaining", "rate", "event", "dead", "tag",
    )

    def __init__(
        self,
        nbytes: float,
        links: Tuple[Link, ...],
        rate_cap: float,
        event: SimEvent,
        tag: str = "",
    ) -> None:
        self.nbytes = nbytes
        self.links = links
        self.rate_cap = rate_cap
        self.remaining = float(nbytes)
        self.rate = 0.0
        self.event = event
        self.dead = False
        self.tag = tag


class SimNetwork:
    """Flows over links with max-min fair sharing, on a SimEnv."""

    def __init__(self, env: SimEnv) -> None:
        self.env = env
        self._links: Dict[str, Link] = {}
        #: insertion-ordered (see Link.flows): deterministic iteration
        self._flows: Dict[Flow, None] = {}
        self._last_advance = 0.0
        #: earliest pending completion tick (de-dup: re-scheduling on every
        #: reallocation without it turns interacting windowed flows into a
        #: stale-tick storm, each tick a global O(flows) reallocation)
        self._next_tick = math.inf
        self.bytes_delivered = 0.0
        #: per-link cumulative bytes (for traffic accounting, Fig 12c)
        self.link_bytes: Dict[str, float] = {}

    # -- topology -------------------------------------------------------------------

    def link(self, name: str, capacity: Optional[float] = None) -> Link:
        lk = self._links.get(name)
        if lk is None:
            if capacity is None:
                raise KeyError(f"unknown link {name}")
            lk = Link(name, capacity)
            self._links[name] = lk
            self.link_bytes[name] = 0.0
        elif capacity is not None and lk.capacity != capacity:
            raise ValueError(f"link {name} redefined with different capacity")
        return lk

    # -- flows ------------------------------------------------------------------------

    def flow(
        self,
        nbytes: float,
        links: Iterable[Link],
        *,
        rate_cap: float = math.inf,
        latency: float = 0.0,
        tag: str = "",
    ) -> SimEvent:
        """Start a flow; returns its completion event. ``latency`` models the
        fixed per-message setup cost (registration, rendezvous, headers)."""
        ev = SimEvent(self.env)
        fl = Flow(nbytes, tuple(links), rate_cap, ev, tag)
        if nbytes <= 0:
            self.env.schedule(latency, ev.succeed)
            return ev

        def start() -> None:
            if fl.dead:
                return
            self._advance_to_now()
            self._flows[fl] = None
            for lk in fl.links:
                lk.flows[fl] = None
            self._reallocate()

        self.env.schedule(latency, start)
        return ev

    def kill_flows(
        self,
        pred: Callable[[Flow], bool],
        *,
        notice_delay: float = 0.0,
        transient: bool = False,
    ) -> int:
        """Abort flows matching pred; waiters get FlowKilled after
        notice_delay (the reader-side failure-detection timeout, 5.1.3).
        ``transient`` flags the kill as a retryable gray fault rather
        than a dead endpoint."""
        victims = [f for f in self._flows if pred(f)]
        self._advance_to_now()
        for fl in victims:
            self._detach(fl)
            fl.dead = True
            self.env.schedule(
                notice_delay,
                (lambda f=fl: f.event.fail(FlowKilled(f.tag, transient=transient))),
            )
        if victims:
            self._reallocate()
        return len(victims)

    # -- fluid model ---------------------------------------------------------------------

    def _detach(self, fl: Flow) -> None:
        self._flows.pop(fl, None)
        for lk in fl.links:
            lk.flows.pop(fl, None)

    def _advance_to_now(self) -> bool:
        """Credit every active flow with rate * elapsed. Returns True when
        any flow finished (the flow set — and hence the rate allocation —
        changed)."""
        dt = self.env.now - self._last_advance
        self._last_advance = self.env.now
        if dt <= 0:
            return False
        finished: List[Flow] = []
        for fl in self._flows:
            moved = min(fl.remaining, fl.rate * dt)
            fl.remaining -= moved
            self.bytes_delivered += moved
            for lk in fl.links:
                self.link_bytes[lk.name] += moved
            # relative epsilon: float rounding can strand sub-byte residues
            # whose completion time underflows now+dt (dt ~ 1e-17 s), which
            # would spin the event loop forever
            if fl.remaining <= max(1e-6, fl.nbytes * 1e-9):
                finished.append(fl)
        for fl in finished:
            self._detach(fl)
            fl.event.succeed()
        return bool(finished)

    def _reallocate(self) -> None:
        """Max-min fair (progressive filling) over all active flows."""
        flows = list(self._flows)
        if not flows:
            return
        unfixed: Dict[Flow, None] = dict.fromkeys(flows)
        cap: Dict[Link, float] = {}
        for fl in flows:
            for lk in fl.links:
                cap.setdefault(lk, lk.capacity)
        for fl in flows:
            fl.rate = 0.0
        while unfixed:
            # bottleneck link: min fair share among links carrying unfixed flows
            best_share = math.inf
            for lk, c in cap.items():
                n = sum(1 for f in lk.flows if f in unfixed)
                if n:
                    best_share = min(best_share, c / n)
            # flows individually capped below the share are fixed at cap
            capped = [f for f in unfixed if f.rate_cap <= best_share]
            if capped:
                for f in capped:
                    f.rate = f.rate_cap
                    unfixed.pop(f, None)
                    for lk in f.links:
                        cap[lk] = max(cap[lk] - f.rate_cap, 0.0)
                continue
            if not math.isfinite(best_share):
                break
            # fix all flows crossing the bottleneck link(s)
            for lk, c in list(cap.items()):
                n = sum(1 for f in lk.flows if f in unfixed)
                if n and abs(c / n - best_share) < 1e-12:
                    for f in [f for f in lk.flows if f in unfixed]:
                        f.rate = best_share
                        unfixed.pop(f, None)
                        for l2 in f.links:
                            cap[l2] = max(cap[l2] - best_share, 0.0)
        self._schedule_next_completion()

    def _schedule_next_completion(self) -> None:
        # Schedule a tick at the earliest completion under *current* rates,
        # but only when it beats the earliest tick already pending: a
        # pending earlier tick re-evaluates anyway, so the true earliest
        # completion stays covered without flooding the heap. Stale ticks
        # (rates changed since) advance the fluid model; they trigger the
        # global reallocation only when a flow actually finished.
        nxt = math.inf
        for fl in self._flows:
            if fl.rate > 0:
                nxt = min(nxt, fl.remaining / fl.rate)
        if not math.isfinite(nxt):
            return
        at = self.env.now + nxt
        if at >= self._next_tick - 1e-15:
            return
        self._next_tick = at

        def tick() -> None:
            if self._next_tick <= self.env.now:
                self._next_tick = math.inf
            if self._advance_to_now():
                self._reallocate()
            else:
                self._schedule_next_completion()

        self.env.schedule(nxt, tick)
