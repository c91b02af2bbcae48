"""Deterministic gray-failure injection + the data plane's healing knobs.

The paper's fault model (4.5) is fail-stop: a worker is alive or dead,
detected by heartbeat expiry. Real preemptible fleets fail *gray* —
sources go slow, hang, flake intermittently, or serve corrupt bytes.
This module provides:

* :class:`FaultSpec` / :class:`FaultPlan` — a declarative, seedable
  schedule of gray faults on named replicas (or the controller),
  expressible identically on both data planes. The sim plane replays a
  plan bit-for-bit from the seed (virtual time, per-fault RNG streams);
  the threaded plane arms the same schedule against the wall clock, so
  fault *decisions* are deterministic per draw while their interleaving
  with real threads is not — byte-identity of the result is the
  threaded-plane oracle.
* :class:`RetryPolicy` — the self-healing knobs the client/sim executors
  consult: per-read deadline, bounded exponential-backoff retries for
  transient errors, and the hedged-read straggler threshold.
* :class:`ThreadedFaultInjector` — the threaded-plane arm, hooked into
  ``LocalTransport`` (``before_read`` delay/flake, payload byte-flips).
* :class:`SimFaultInjector` — the sim-plane arm, installed via
  ``SimCluster.install_faults``: crash/slow/hang faults become scheduled
  link-capacity events on the fluid network; flaky/corrupt faults are
  per-flow seeded draws.

Faults address *sources*: a ``slow`` fault degrades the target replica's
NIC links, ``flaky``/``corrupt`` afflict reads served by the target.
``corrupt`` faults flip a byte in the served payload **before** the
destination-side checksum verification, so they exercise the
checksum-reject + re-fetch path; they require verification to be on
(the default) — with verification disabled the flip would propagate.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.transfer.hardware import CLUSTER

FAULT_KINDS = ("crash", "hang", "slow", "flaky", "corrupt", "truncate")

#: reserved target name addressing the reference server rather than a
#: replica (sim plane: a scheduled crash_and_recover)
CONTROLLER = "controller"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    kind
        ``crash``  — fail-stop the target at ``start`` (sim: kill_replica /
        crash_and_recover for the controller).
        ``hang``   — reads from the target block (threaded) / its links
        carry zero bandwidth (sim) for ``duration``.
        ``slow``   — gray degradation: sim links scaled to ``severity`` x
        healthy capacity; threaded reads delayed by ``stall`` seconds.
        ``flaky``  — each read/flow from the target fails with a
        *transient* error with probability ``severity``.
        ``corrupt``— each read from the target is corrupted (byte flip /
        checksum reject) with probability ``severity``.
        ``truncate``— each *codec-framed* read from the target ships a
        torn wire frame (tail dropped) with probability ``severity``;
        the destination's decode fails the frame-size integrity check
        with a ``CodecError`` — the decode-failure healing path, distinct
        from ``corrupt``'s checksum reject. Threaded plane only (the sim
        moves no real frames); raw reads are unaffected.
    target
        Replica name, or :data:`CONTROLLER`.
    start / duration
        Fault window in seconds (virtual time on the sim plane, seconds
        since ``arm()`` on the threaded plane). ``crash`` ignores
        ``duration``.
    severity
        ``slow``: remaining bandwidth fraction. ``flaky``/``corrupt``:
        per-read probability.
    stall
        Threaded-plane ``slow`` only: extra seconds per read (wall-clock
        stand-in for the sim's bandwidth scaling).
    direction
        ``slow``/``hang`` only: which NIC direction degrades on the sim
        plane ("both", "up", or "down").
    """

    kind: str
    target: str
    start: float = 0.0
    duration: float = math.inf
    severity: float = 1.0
    stall: float = 0.0
    direction: str = "both"

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.direction not in ("both", "up", "down"):
            raise ValueError(f"bad fault direction {self.direction!r}")
        if not 0.0 <= self.severity <= 1.0:
            raise ValueError(f"severity must be in [0, 1], got {self.severity}")

    def active(self, now: float) -> bool:
        return self.start <= now < self.start + self.duration


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of faults, replayable bit-for-bit.

    Each fault gets its own RNG stream derived from ``(seed, index)``, so
    adding or removing one fault never perturbs the draws of the others.
    """

    seed: int = 0
    faults: Tuple[FaultSpec, ...] = ()

    def __init__(self, seed: int = 0, faults: Iterable[FaultSpec] = ()) -> None:
        object.__setattr__(self, "seed", seed)
        object.__setattr__(self, "faults", tuple(faults))

    def rng(self, index: int) -> random.Random:
        # string seeds hash via SHA-512: stable across processes, unlike
        # tuple seeds (deprecated, PYTHONHASHSEED-dependent)
        return random.Random(f"{self.seed}/{index}")

    def for_target(self, target: str) -> List[Tuple[int, FaultSpec]]:
        return [(i, f) for i, f in enumerate(self.faults) if f.target == target]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Self-healing knobs consulted by both data-plane executors.

    fail_detect
        Per-read deadline: an in-flight read silent for longer is
        reported to the server as *transient* evidence against its
        source. Defaults to the calibrated RDMA failure-detection
        timeout — the same knob ``benchmarks/micro_failure.py`` measures.
    retry_limit / retry_backoff
        Bounded retries for transient errors, with exponential backoff
        ``retry_backoff * 2**attempt``. Also bounds how many times one
        unit may be checksum-rejected before the error is considered
        genuine bad data and propagates.
    hedge_threshold / hedge_min_samples
        Hedged reads: an idle source worker duplicates the slowest
        in-flight unit of a sibling once its age exceeds
        ``hedge_threshold`` x the median observed fetch time (needs at
        least ``hedge_min_samples`` completed fetches to estimate the
        baseline). Whichever twin finishes first delivers; the loser's
        byte-identical result is discarded.
    """

    fail_detect: float = CLUSTER.rdma_fail_detect
    retry_limit: int = 3
    retry_backoff: float = 0.05
    hedge_threshold: float = 3.0
    hedge_min_samples: int = 3

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based)."""
        return self.retry_backoff * (2.0 ** (attempt - 1))


DEFAULT_RETRY_POLICY = RetryPolicy()


class ThreadedFaultInjector:
    """Threaded-plane fault arm, hooked into ``LocalTransport``.

    ``before_read`` runs at the top of every transport read and applies
    hang (bounded block), slow (sleep), and flaky (transient
    ``TransportError``) faults; ``corrupts``/``flip`` implement byte
    corruption of the served payload ahead of destination-side
    verification. The schedule is armed against a wall-clock origin
    (:meth:`arm`); :meth:`release` permanently unblocks hangs so tests
    and benchmarks can drain hung reader threads deterministically.
    """

    _TICK = 0.005  # hang-block granularity: bounded, interruptible sleep

    def __init__(self, plan: FaultPlan, *, clock=time.monotonic) -> None:
        self.plan = plan
        self.clock = clock
        self._t0: Optional[float] = None
        self._released = False
        self._rngs: Dict[int, random.Random] = {
            i: plan.rng(i) for i, _ in enumerate(plan.faults)
        }
        self._by_target: Dict[str, List[Tuple[int, FaultSpec]]] = {}
        for i, spec in enumerate(plan.faults):
            self._by_target.setdefault(spec.target, []).append((i, spec))

    # -- lifecycle ------------------------------------------------------------

    def arm(self) -> "ThreadedFaultInjector":
        """Start the schedule clock (idempotent)."""
        if self._t0 is None:
            self._t0 = self.clock()
        return self

    def release(self) -> None:
        """Permanently unblock hang faults (lets hung reads drain)."""
        self._released = True

    @property
    def now(self) -> float:
        if self._t0 is None:
            self.arm()
        return self.clock() - self._t0

    # -- transport hooks ------------------------------------------------------

    def _active(self, kind: str, target: str) -> Optional[Tuple[int, FaultSpec]]:
        now = self.now
        for i, spec in self._by_target.get(target, ()):
            if spec.kind == kind and spec.active(now):
                return i, spec
        return None

    def before_read(self, replica: str, shard_idx: int) -> None:
        """Apply hang/slow/flaky faults ahead of a read from ``replica``."""
        from repro_torch.core.errors import TransportError

        hit = self._active("hang", replica)
        if hit is not None:
            _, spec = hit
            while not self._released and spec.active(self.now):
                time.sleep(self._TICK)
        hit = self._active("slow", replica)
        if hit is not None and hit[1].stall > 0.0:
            time.sleep(hit[1].stall)
        hit = self._active("flaky", replica)
        if hit is not None:
            i, spec = hit
            if self._rngs[i].random() < spec.severity:
                raise TransportError(
                    f"injected flaky read from {replica}", transient=True
                )

    def corrupts(self, replica: str) -> bool:
        """Draw whether the current read from ``replica`` is corrupted."""
        hit = self._active("corrupt", replica)
        if hit is None:
            return False
        i, spec = hit
        return self._rngs[i].random() < spec.severity

    def truncates(self, replica: str) -> bool:
        """Draw whether the current codec-framed read from ``replica``
        ships a torn (tail-truncated) wire frame."""
        hit = self._active("truncate", replica)
        if hit is None:
            return False
        i, spec = hit
        return self._rngs[i].random() < spec.severity

    def flip(self, payload) -> None:
        """Flip one byte of ``payload`` (a contiguous tensor, on any
        device) in place."""
        flat = payload.reshape(-1).view(torch.uint8)
        if flat.numel() == 0:
            return
        # deterministic position per plan seed; independent of draw RNGs
        idx = random.Random(f"{self.plan.seed}/flip/{int(flat.numel())}").randrange(
            flat.numel()
        )
        flat[idx] ^= 0xFF

    def controller_crashes(self) -> List[float]:
        """Scheduled controller-crash times (applied by the harness: the
        threaded plane's controller crash is ``ReferenceServer.crash()``
        + ``failover.recover``, driven from test/benchmark code)."""
        return sorted(
            f.start for _, f in self._by_target.get(CONTROLLER, ())
            if f.kind == "crash"
        )

class SimFaultInjector:
    """Sim-plane fault arm: schedules a :class:`FaultPlan` as virtual-time
    events on a ``SimCluster``.

    crash  -> ``cluster.kill_replica`` (controller: ``crash_and_recover``)
    slow   -> target's up/down RDMA links scaled to ``severity`` for the
              window, then restored (``hang`` is ``slow`` at 0.0 — the
              max-min allocator gives flows on a zero-capacity link rate
              zero, and they resume when capacity returns)
    flaky  -> a seeded draw per flow creation; a hit schedules a
              *transient* kill of that flow shortly after it starts
    corrupt-> a seeded draw per completed flow; the sim moves no real
              bytes, so a hit manifests as a checksum reject at delivery
    """

    def __init__(self, cluster, plan: FaultPlan) -> None:
        self.cluster = cluster
        self.plan = plan
        #: schedule origin: fault windows are relative to installation
        #: time, mirroring the threaded injector's ``arm()`` clock origin
        #: (a plan can be armed mid-run, after a healthy warm-up phase)
        self.origin = float(cluster.env.now)
        self._rngs: Dict[int, random.Random] = {
            i: plan.rng(i) for i, _ in enumerate(plan.faults)
        }
        self._by_target: Dict[str, List[Tuple[int, FaultSpec]]] = {}
        for i, spec in enumerate(plan.faults):
            self._by_target.setdefault(spec.target, []).append((i, spec))
        self._base_capacity: Dict[str, float] = {}

    def install(self) -> None:
        env = self.cluster.env
        for i, spec in enumerate(self.plan.faults):
            if spec.target == CONTROLLER:
                if spec.kind == "crash":
                    env.schedule(spec.start, self.cluster.crash_and_recover)
                continue
            if spec.kind == "crash":
                env.schedule(
                    spec.start,
                    lambda t=spec.target: self.cluster.kill_replica(t),
                )
            elif spec.kind in ("slow", "hang"):
                factor = 0.0 if spec.kind == "hang" else spec.severity
                env.schedule(
                    spec.start, lambda s=spec, f=factor: self._scale(s, f)
                )
                if math.isfinite(spec.duration):
                    env.schedule(
                        spec.start + spec.duration,
                        lambda s=spec: self._scale(s, 1.0),
                    )
            # flaky/corrupt are queried at flow boundaries, not scheduled

    def _scale(self, spec: FaultSpec, factor: float) -> None:
        """Scale the target replica's NIC links; 1.0 restores healthy."""
        net = self.cluster.net
        net._advance_to_now()
        for (rep, _idx), w in self.cluster._workers.items():
            if rep != spec.target:
                continue
            links = {"both": (w.up, w.down), "up": (w.up,), "down": (w.down,)}[
                spec.direction
            ]
            for lk in links:
                base = self._base_capacity.setdefault(lk.name, lk.capacity)
                lk.capacity = base * factor
        net._reallocate()

    def _hit(self, kind: str, replica: str, now: float) -> bool:
        for i, spec in self._by_target.get(replica, ()):
            if spec.kind == kind and spec.active(now - self.origin):
                if self._rngs[i].random() < spec.severity:
                    return True
        return False

    def flaky_hit(self, replica: str, now: float) -> bool:
        return self._hit("flaky", replica, now)

    def corrupt_hit(self, replica: str, now: float) -> bool:
        return self._hit("corrupt", replica, now)
