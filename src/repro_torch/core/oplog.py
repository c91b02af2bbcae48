"""Replayable op log for the control plane (fault tolerance).

Every state-mutating :class:`~repro_torch.core.server.ReferenceServer` entry
point appends one :class:`OpRecord` — op name, logical sequence number,
and the call's arguments as a serializable payload — *before* executing.
Because the server is deterministic (no wall clock, no RNG; time enters
only as explicit ``now`` arguments), replaying the records in order
rebuilds a bit-identical server: that is what ``repro_torch.core.failover``
does after a controller crash.

Durability model
----------------
``append`` buffers records in an in-memory *tail*; ``flush`` moves the
tail to the *committed* region (and, when a ``path`` is configured,
writes JSONL lines through to the file). ``group_commit=N`` auto-flushes
every N records — the classic group-commit batch that amortizes the
sync cost across concurrent writers. A crash loses the unflushed tail
(:meth:`lose_tail` simulates exactly that); recovery replays the
committed region only, and clients re-assert whatever the tail carried
(their registration, published version, and in-flight progress — see
``ShardHandle.reassert``).

Compaction
----------
:meth:`compact` installs a :class:`Snapshot` (a full serialized server
state at some sequence number, built by ``failover.take_snapshot``) and
drops every record it covers, making recovery O(live state) instead of
O(history).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

from repro_torch.core.errors import TensorHubError
from repro_torch.core.meta import ShardManifest, from_wire, to_wire


#: per-op argument schemas, in ReferenceServer method signature order.
#: The hot path logs a bare positional tuple (building one kwargs dict
#: per mutation would already cost a measurable fraction of an in-process
#: publish); names are reattached lazily at replay/serialization time —
#: exactly how a real RPC layer's fixed wire schema works.
OP_SCHEMAS: Dict[str, tuple] = {
    "open": ("model", "replica", "num_shards", "shard_idx", "worker", "retain"),
    "register": ("model", "replica", "shard_idx"),
    "unregister": ("model", "replica", "shard_idx"),
    "close": ("model", "replica", "shard_idx"),
    "heartbeat": ("model", "replica", "shard_idx", "now"),
    "tick": ("now",),
    "fail_replica": ("model", "replica", "reason"),
    # evidence/now were appended for gray-failure classification; records
    # logged before that carry 3 args and replay with the server defaults
    # (zip() in kwargs() stops at the shorter tuple)
    "report_transfer_failure": (
        "model", "dest_replica", "source_replica", "evidence", "now",
    ),
    "publish": ("model", "replica", "shard_idx", "version", "manifest", "op_id"),
    "publish_offload": (
        "model", "replica", "shard_idx", "version", "manifest", "op_id",
    ),
    "unpublish": ("model", "replica", "shard_idx", "op_id"),
    "finish_unpublish": ("model", "replica"),
    "begin_replicate": ("model", "replica", "shard_idx", "spec", "op_id"),
    "begin_update": (
        "model", "replica", "shard_idx", "spec", "op_id", "offload_seeding",
    ),
    "update_progress": ("model", "replica", "shard_idx", "version", "progress"),
    "complete_replicate": ("model", "replica", "shard_idx", "version", "op_id"),
    "put_manifest": ("model", "replica", "shard_idx", "version", "manifest"),
    "poll_events": ("worker_id",),
}


class OpRecord(NamedTuple):
    """One logged control-plane mutation. ``args`` is positional, in
    ``OP_SCHEMAS[op]`` order; :meth:`kwargs` reattaches the names."""

    seq: int
    op: str  # ReferenceServer method name
    args: tuple

    def kwargs(self) -> Dict[str, object]:
        return dict(zip(OP_SCHEMAS[self.op], self.args))


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Serialized full server state as of (and including) record ``seq``."""

    seq: int
    state: dict  # wire-encoded (JSON-able) — see failover.take_snapshot


class OpLog:
    """Append-only op log with group-commit batching and compaction."""

    def __init__(
        self, *, group_commit: int = 1, path: Optional[str] = None
    ) -> None:
        if group_commit < 1:
            raise ValueError(f"group_commit must be >= 1, got {group_commit}")
        self.group_commit = group_commit
        self.path = path
        #: server construction knobs, written once by the first server
        #: attached to this log; recovery rebuilds the server from them
        self.config: Optional[Dict[str, object]] = None
        self.snapshot: Optional[Snapshot] = None
        #: raw (seq, op, args) tuples — OpRecord views are materialized
        #: lazily by committed() / the on_append hook, off the hot path
        self._committed: List[tuple] = []
        self._tail: List[tuple] = []
        self._seq = 0
        #: test/benchmark hook: called after every append (and after the
        #: auto-flush it may trigger) with the new record — the crash
        #: sweeps use it to kill the controller at exact op boundaries
        self.on_append: Optional[Callable[[OpRecord], None]] = None
        self.flushes = 0
        self._fp = None
        #: file-sink manifest interning: a ShardManifest is encoded once
        #: as a "blob" line and later records reference it by key — the
        #: log moves lightweight references, like the server itself
        self._blob_ids: Dict[int, int] = {}
        #: blob-key base for the file sink. Seeded past the keys already
        #: present when a log file is reopened (:meth:`open_path`) so a
        #: restarted controller never reuses a live key — readers resolve
        #: blob references in file order, but distinct keys keep the file
        #: greppable and compaction-safe regardless of interleaving.
        self._blob_base = 0
        if path is not None:
            self._fp = open(path, "a", encoding="utf-8")
        #: direct mode: memory sink with group_commit=1 — every append is
        #: instantly durable, so records skip the tail/flush machinery
        #: entirely (this is the control plane's hot path)
        self._direct = path is None and group_commit == 1

    # -- write path -----------------------------------------------------------

    def set_config(self, config: Dict[str, object]) -> None:
        """First attached server wins; a conflicting re-attach is a bug."""
        if self.config is None:
            self.config = dict(config)
            if self._fp is not None:
                self._fp.write(
                    json.dumps({"kind": "config", "config": self.config}) + "\n"
                )
        elif self.config != config:
            raise TensorHubError(
                "op log already carries a different server config; recover "
                "through repro_torch.core.failover instead of re-initializing"
            )

    def append(self, op: str, args: tuple = ()) -> None:
        # hot path: one bare tuple per mutation, args stored by reference
        # (frozen metadata records or scalars) — never copied or encoded
        # here. The file sink encodes lazily at flush, amortized by the
        # group commit; to_jsonl encodes on demand.
        self._seq += 1
        if self._direct:
            self._committed.append((self._seq, op, args))
        else:
            self._tail.append((self._seq, op, args))
            if len(self._tail) >= self.group_commit:
                self.flush()
        cb = self.on_append
        if cb is not None:
            cb(OpRecord(self._seq, op, args))

    def _encode_into(
        self,
        records,
        blob_ids: Dict[int, int],
        lines: List[str],
        *,
        base: int = 0,
    ) -> None:
        """Encode records as JSONL, interning each distinct manifest as a
        one-time "blob" line that later records reference by key (allocated
        from ``base + 1`` upward)."""
        for seq, op, args in records:
            enc = []
            for a in args:
                if isinstance(a, ShardManifest):
                    key = blob_ids.get(id(a))
                    if key is None:
                        key = base + len(blob_ids) + 1
                        blob_ids[id(a)] = key
                        lines.append(
                            json.dumps(
                                {"kind": "blob", "key": key, "value": to_wire(a)}
                            )
                        )
                    enc.append({"__blob__": key})
                else:
                    enc.append(to_wire(a))
            lines.append(
                json.dumps({"kind": "op", "seq": seq, "op": op, "args": enc})
            )

    def flush(self) -> None:
        """Commit the tail (group commit): the records become durable."""
        if not self._tail:
            return
        if self._fp is not None:
            lines: List[str] = []
            self._encode_into(self._tail, self._blob_ids, lines, base=self._blob_base)
            self._fp.write("\n".join(lines) + "\n")
            self._fp.flush()
        self._committed.extend(self._tail)
        self._tail.clear()
        self.flushes += 1

    def lose_tail(self) -> int:
        """Crash simulation: drop the unflushed tail; returns the count.

        Sequence numbers are not reused — replay tolerates gaps because
        every op is idempotent under re-delivery."""
        n = len(self._tail)
        self._tail = []
        return n

    def compact(self, snapshot: Snapshot) -> None:
        """Install a snapshot and drop the records it covers."""
        self.flush()
        self.snapshot = snapshot
        self._committed = [r for r in self._committed if r[0] > snapshot.seq]
        if self._fp is not None:  # rewrite: snapshot line + surviving suffix
            # crash-safe: build the compacted image in a temp file and
            # atomically rename it over the log — truncating in place
            # would destroy the whole durable history on a crash mid-write
            self._fp.close()
            tmp_path = self.path + ".compact"
            self._blob_ids = {}  # fresh file: re-intern on demand
            self._blob_base = 0
            lines: List[str] = []
            if self.config is not None:
                lines.append(json.dumps({"kind": "config", "config": self.config}))
            lines.append(
                json.dumps(
                    {"kind": "snapshot", "seq": snapshot.seq, "state": snapshot.state}
                )
            )
            self._encode_into(self._committed, self._blob_ids, lines)
            with open(tmp_path, "w", encoding="utf-8") as tmp:
                if lines:
                    tmp.write("\n".join(lines) + "\n")
                tmp.flush()
                os.fsync(tmp.fileno())
            os.replace(tmp_path, self.path)
            self._fp = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        self.flush()
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    # -- read path ------------------------------------------------------------

    @property
    def last_seq(self) -> int:
        """Sequence number of the last appended (not necessarily
        committed) record."""
        return self._seq

    @property
    def committed_seq(self) -> int:
        return self._committed[-1][0] if self._committed else (
            self.snapshot.seq if self.snapshot is not None else 0
        )

    def committed(self, after: int = 0) -> Iterator[OpRecord]:
        """Durable records with seq > ``after``, in order."""
        for seq, op, args in self._committed:
            if seq > after:
                yield OpRecord(seq, op, args)

    def __len__(self) -> int:
        return len(self._committed) + len(self._tail)

    # -- serialization --------------------------------------------------------

    def to_jsonl(self) -> str:
        """Durable content (config + snapshot + committed records) as
        JSONL — what a crash leaves on disk."""
        lines: List[str] = []
        if self.config is not None:
            lines.append(json.dumps({"kind": "config", "config": self.config}))
        if self.snapshot is not None:
            lines.append(
                json.dumps(
                    {
                        "kind": "snapshot",
                        "seq": self.snapshot.seq,
                        "state": self.snapshot.state,
                    }
                )
            )
        self._encode_into(self._committed, {}, lines)
        return "\n".join(lines) + ("\n" if lines else "")

    @classmethod
    def from_jsonl(cls, text: str, *, group_commit: int = 1) -> "OpLog":
        log = cls(group_commit=group_commit)
        blobs: Dict[int, object] = {}

        def arg(a):
            if isinstance(a, dict) and "__blob__" in a:
                return blobs[a["__blob__"]]
            return from_wire(a)

        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            kind = obj.get("kind")
            if kind == "config":
                log.config = obj["config"]
            elif kind == "snapshot":
                log.snapshot = Snapshot(seq=obj["seq"], state=obj["state"])
            elif kind == "blob":
                blobs[obj["key"]] = from_wire(obj["value"])
                log._blob_base = max(log._blob_base, int(obj["key"]))
            elif kind == "op":
                rec = (obj["seq"], obj["op"], tuple(arg(a) for a in obj["args"]))
                log._committed.append(rec)
                log._seq = max(log._seq, rec[0])
            else:
                raise TensorHubError(f"bad op-log line kind: {kind!r}")
        if log.snapshot is not None:
            log._seq = max(log._seq, log.snapshot.seq)
        return log

    @classmethod
    def open_path(
        cls, path: str, *, group_commit: int = 1
    ) -> "OpLog":
        """Reopen a file-backed log in place: parse the durable content
        that a crash (or clean shutdown) left at ``path``, then continue
        appending to the same file.

        This is the networked controller's restart path —
        ``repro_torch.core.failover.recover_path`` feeds the parsed records to
        replay and hands the still-attached log back to the rebuilt
        server, so the WAL keeps growing where the dead process stopped.
        Sequence numbers continue past the parsed maximum and blob keys
        are allocated past any key already present in the file; replay
        resolves blob references in file order either way."""
        try:
            with open(path, "r", encoding="utf-8") as fh:
                text = fh.read()
        except FileNotFoundError:
            text = ""
        log = cls.from_jsonl(text, group_commit=group_commit)
        log.path = path
        log._fp = open(path, "a", encoding="utf-8")
        log._direct = False  # records must reach the file sink via flush
        return log


