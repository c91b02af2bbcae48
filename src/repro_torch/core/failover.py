"""Controller failover: snapshot, replay, and recovery of the reference
server from its op log.

The server is deterministic — no wall clock, no RNG, time only as
explicit arguments — so replaying the logged op sequence rebuilds a
bit-identical ``ReferenceServer``. :func:`take_snapshot` serializes the
*entire* live state (models, replicas, per-version states, manifests,
open and retired group transactions, parked replicates, event queues,
stats) so that :meth:`~repro_torch.core.oplog.OpLog.compact` can truncate
history: recovery then restores the snapshot and replays only the
suffix, making it O(live state) instead of O(history).

Replayed ops that raised during the live run raise identically during
replay (same state, same code path); :func:`recover` swallows them —
the live caller already saw the error, and any partial mutation the op
made before raising is reproduced exactly by re-running it.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.errors import TensorHubError
from repro_torch.core.meta import from_wire, to_wire
from repro_torch.core.oplog import OpLog, OpRecord, Snapshot
from repro_torch.core.server import ModelState, ReferenceServer, _Txn

# ---------------------------------------------------------------------------
# state serialization
# ---------------------------------------------------------------------------


def _encode_txn(txn: _Txn) -> dict:
    # on_last is deliberately dropped: it is rebuilt from the op kind on
    # restore (only "complete" group ops carry one)
    return {
        "op": txn.op,
        "args_repr": txn.args_repr,
        "result": to_wire(txn.result),
        "arrived": sorted(txn.arrived),
    }


def _decode_txn(w: dict) -> _Txn:
    return _Txn(
        op=w["op"],
        args_repr=w["args_repr"],
        result=from_wire(w["result"]),
        arrived=set(w["arrived"]),
    )


def _encode_model(st: ModelState) -> dict:
    return {
        "name": st.name,
        "num_shards": st.num_shards,
        "latest": st.latest,
        "replicas": to_wire(st.replicas),
        "versions": to_wire(st.versions),
        "manifests": to_wire(st.manifests),
        "replica_manifests": to_wire(st.replica_manifests),
        "txns": [[to_wire(k), _encode_txn(t)] for k, t in st.txns.items()],
        "done_txns": [[to_wire(k), _encode_txn(t)] for k, t in st.done_txns.items()],
        "pending": to_wire(st.pending),
        "source_gen": to_wire(st.source_gen),
    }


def _decode_model(server: ReferenceServer, w: dict) -> ModelState:
    st = ModelState(name=w["name"])
    st.num_shards = w["num_shards"]
    st.latest = w["latest"]
    st.replicas = from_wire(w["replicas"])
    st.versions = from_wire(w["versions"])
    st.manifests = from_wire(w["manifests"])
    st.replica_manifests = from_wire(w["replica_manifests"])
    st.pending = from_wire(w["pending"])
    st.source_gen = from_wire(w["source_gen"])
    for kw, tw in w["txns"]:
        key = from_wire(kw)
        key = tuple(key) if isinstance(key, list) else key
        txn = _decode_txn(tw)
        if txn.op == "complete":
            # the only group op with a completion callback; its closure
            # binds (state, version, replica) — all replayable
            txn.on_last = server._complete_on_last(  # noqa: SLF001
                st, int(txn.args_repr), key[0]
            )
        st.txns[key] = txn
    for kw, tw in w["done_txns"]:
        key = from_wire(kw)
        st.done_txns[tuple(key) if isinstance(key, list) else key] = _decode_txn(tw)
    return st


def encode_state(server: ReferenceServer) -> dict:
    """The server's complete durable state as a JSON-able wire tree.

    The watcher-notification counter (``server.seq``) is deliberately
    excluded: it counts *calls* (including no-op polls the log skips),
    not state, so it is neither durable nor replay-deterministic."""
    return {
        "models": [
            [name, _encode_model(st)]
            for name, st in server._models.items()  # noqa: SLF001
        ],
        "events": to_wire(server._events),  # noqa: SLF001
        "stats": dict(server.stats),
    }


def restore_state(server: ReferenceServer, state: dict) -> None:
    """Overwrite ``server``'s state with a decoded snapshot."""
    server._models = {  # noqa: SLF001
        name: _decode_model(server, mw) for name, mw in state["models"]
    }
    server._events = from_wire(state["events"])  # noqa: SLF001
    server.stats = dict(state["stats"])


def take_snapshot(server: ReferenceServer, *, seq: Optional[int] = None) -> Snapshot:
    """Serialize the live server as of the last logged record. Pass the
    result to :meth:`OpLog.compact` to truncate the history it covers."""
    if seq is None:
        seq = server.log.last_seq if server.log is not None else 0
    return Snapshot(seq=seq, state=encode_state(server))


def state_digest(server: ReferenceServer) -> str:
    """Canonical fingerprint of the full server state — two servers with
    equal digests are bit-identical (the crash-sweep test oracle)."""
    return hashlib.sha256(
        json.dumps(encode_state(server), sort_keys=True).encode()
    ).hexdigest()


# ---------------------------------------------------------------------------
# replay / recovery
# ---------------------------------------------------------------------------


def apply_record(server: ReferenceServer, rec: OpRecord) -> None:
    """Re-execute one logged op. Deterministic failures are part of the
    history: an op that raised live raises identically here and is
    swallowed (its partial mutations replay exactly by re-running)."""
    try:
        getattr(server, rec.op)(**rec.kwargs())
    except (TensorHubError, ValueError):
        pass


def recover(
    log: OpLog, **config_overrides: Any
) -> ReferenceServer:
    """Rebuild a bit-identical server from an op log: construct from the
    logged config, restore the compaction snapshot (if any), replay the
    committed suffix, then attach the log so new ops keep appending
    where the crashed server stopped. Clients switch over via
    ``TensorHubClient.failover`` / ``SimCluster.crash_and_recover``."""
    t0 = time.perf_counter()
    cfg: Dict[str, Any] = dict(log.config or {})
    cfg.update(config_overrides)
    server = ReferenceServer(**cfg)
    start = 0
    if log.snapshot is not None:
        restore_state(server, log.snapshot.state)
        start = log.snapshot.seq
    for rec in log.committed(after=start):
        apply_record(server, rec)
    server.attach_log(log)
    # metrics gauge only — wall-clock values live outside the replayed
    # state digest, so the recovered twin still digests equal
    server.last_recovery_s = time.perf_counter() - t0
    return server


def recover_path(
    path: str, *, group_commit: int = 1, **config_overrides: Any
) -> ReferenceServer:
    """Recover a controller from its on-disk JSONL WAL and keep appending
    to the same file — the restart path of the networked controller
    (``repro_torch.net.controller --recover``). The rebuilt server is
    bit-identical to the crashed one's durable state; new mutations flush
    to the same ``path`` with sequence numbers and blob keys continuing
    past the parsed maximum."""
    log = OpLog.open_path(path, group_commit=group_commit)
    return recover(log, **config_overrides)


def replay(
    records, *, config: Optional[Dict[str, Any]] = None
) -> ReferenceServer:
    """Replay a bare record sequence into a fresh (log-less) server —
    the replay-equivalence property tests drive this directly."""
    server = ReferenceServer(**(config or {}))
    for rec in records:
        apply_record(server, rec)
    return server


__all__ = [
    "Snapshot",
    "apply_record",
    "encode_state",
    "recover",
    "recover_path",
    "replay",
    "restore_state",
    "state_digest",
    "take_snapshot",
]
