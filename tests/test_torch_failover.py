"""Controller failover in the port against the JAX package.

The op traces of ``tests/test_failover.py`` run through both packages'
servers: a seeded random trace and the simulator's publish -> replicate
-> update trace are recorded by a JAX server's op log, carried to the
port as the log's JSONL image (the WAL bytes), and replayed record by
record through both packages' ``apply_record``; the port's
``state_digest`` must equal the JAX package's at every op boundary (the
digest hashes the wire encoding of the whole server state, so this holds
the port's server, op log and wire codec to the reference's). Then:
snapshot plus suffix, a crash (recovery from the log prefix) at every
op boundary followed by the rest of the trace, compaction, redelivery,
WAL files written by one package recovered by the other, and a threaded
crash mid-pull through the port's client with stores on the CPU.
"""

import json
import random
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jax_core  # noqa: E402
from repro.core import failover as jax_failover  # noqa: E402
from repro.core.meta import ShardManifest as JaxManifest  # noqa: E402
from repro.core.meta import TensorMeta as JaxMeta  # noqa: E402
from repro.core.meta import TransferUnit as JaxUnit  # noqa: E402
from repro.core.meta import WorkerInfo as JaxWorkerInfo  # noqa: E402
from repro.core.oplog import OpLog as JaxOpLog  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import failover as port_failover  # noqa: E402
from repro_torch.core.meta import ShardManifest as PortManifest  # noqa: E402
from repro_torch.core.meta import TensorMeta as PortMeta  # noqa: E402
from repro_torch.core.meta import TransferUnit as PortUnit  # noqa: E402
from repro_torch.core.meta import WorkerInfo as PortWorkerInfo  # noqa: E402
from repro_torch.core.oplog import OpLog as PortOpLog  # noqa: E402

from test_failover import _random_trace, _sim_trace  # noqa: E402

SEEDS = [0, 1, 2, 3, 7, 11, 1234, 2**30 - 1]


def _port_log(jax_log: JaxOpLog) -> PortOpLog:
    """The JAX log's durable image (what a crash leaves on disk), parsed
    by the port."""
    return PortOpLog.from_jsonl(jax_log.to_jsonl())


def _jax_log(port_log: PortOpLog) -> JaxOpLog:
    return JaxOpLog.from_jsonl(port_log.to_jsonl())


def _prefix(text: str, k: int) -> str:
    """A log image cut after its k-th op record (config, snapshot and
    blob lines before it kept): the WAL of a controller that died at
    that op boundary."""
    out, ops = [], 0
    for line in text.splitlines():
        if json.loads(line).get("kind") == "op":
            if ops == k:
                break
            ops += 1
        out.append(line)
    return "\n".join(out) + "\n"


def _recorded_random(seed, n_ops=40):
    log = JaxOpLog()
    live = jax_core.ReferenceServer(log=log)
    _random_trace(live, random.Random(seed), n_ops=n_ops)
    return live, log


def _recorded_sim():
    cl, log, done, _ = _sim_trace()
    assert all(done)
    cl.server.attach_log(None)
    return cl.server, log


def _assert_replay_equal_at_every_boundary(live, log):
    cfg = dict(log.config or {})
    jax_srv = jax_core.ReferenceServer(**cfg)
    port_srv = port_core.ReferenceServer(**cfg)
    assert port_failover.state_digest(port_srv) == jax_failover.state_digest(jax_srv)
    jrecs = list(log.committed())
    precs = list(_port_log(log).committed())
    assert [(r.seq, r.op) for r in precs] == [(r.seq, r.op) for r in jrecs]
    for jr, pr in zip(jrecs, precs):
        jax_failover.apply_record(jax_srv, jr)
        port_failover.apply_record(port_srv, pr)
        assert port_failover.state_digest(port_srv) == jax_failover.state_digest(jax_srv), (
            f"digest diverged after record {jr.seq} ({jr.op})"
        )
    assert port_failover.state_digest(port_srv) == jax_failover.state_digest(live)
    return port_srv


@pytest.mark.parametrize("seed", SEEDS)
def test_random_trace_digest_equal_at_every_boundary(seed):
    live, log = _recorded_random(seed)
    port_srv = _assert_replay_equal_at_every_boundary(live, log)
    assert port_srv.list_versions("m") == live.list_versions("m")
    # and the whole log recovers through the port to the live JAX server
    rec = port_failover.recover(_port_log(log))
    assert port_failover.state_digest(rec) == jax_failover.state_digest(live)


def test_sim_trace_digest_equal_at_every_boundary():
    live, log = _recorded_sim()
    assert log.last_seq > 40
    _assert_replay_equal_at_every_boundary(live, log)


def test_crash_at_every_op_boundary():
    """The controller dies after each record of the simulator's trace in
    turn: the port recovers from that WAL prefix to the JAX package's
    recovered digest, then takes the rest of the trace and ends at the
    uncrashed run's final state."""
    live, log = _recorded_sim()
    want = jax_failover.state_digest(live)
    text = log.to_jsonl()
    recs = list(_port_log(log).committed())
    for k in range(1, len(recs) + 1):
        prefix = _prefix(text, k)
        port_rec = port_failover.recover(PortOpLog.from_jsonl(prefix))
        jax_rec = jax_failover.recover(JaxOpLog.from_jsonl(prefix))
        assert port_failover.state_digest(port_rec) == jax_failover.state_digest(jax_rec), k
        port_rec.attach_log(None)
        for rec in recs[k:]:
            port_failover.apply_record(port_rec, rec)
        assert port_failover.state_digest(port_rec) == want, f"state diverged after a crash at record {k}"


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_snapshot_prefix_plus_suffix(seed):
    """A snapshot at a record prefix, then only the suffix replayed: the
    port's own snapshot of its replay, and the JAX package's snapshot
    carried across in the WAL image, both recover to the live digest."""
    cut = 1 + seed % 30
    log = JaxOpLog()
    live = jax_core.ReferenceServer(log=log)
    snap = {}

    def hook(rec):
        if rec.seq == cut and not snap:
            snap["s"] = jax_failover.take_snapshot(live, seq=rec.seq - 1)

    log.on_append = hook
    _random_trace(live, random.Random(seed), n_ops=40)
    want = jax_failover.state_digest(live)
    assert snap
    # the port's snapshot of its own replay of the prefix
    plog = _port_log(log)
    replica = port_failover.replay(list(plog.committed())[: cut - 1], config=plog.config)
    plog.compact(port_failover.take_snapshot(replica, seq=cut - 1))
    assert port_failover.state_digest(port_failover.recover(plog)) == want
    assert plog.snapshot.state == snap["s"].state  # the two packages' snapshots are the same tree
    # the JAX package's snapshot, recovered through the port
    log.compact(snap["s"])
    assert port_failover.state_digest(port_failover.recover(_port_log(log))) == want
    # and the port's compacted log, recovered through the JAX package
    assert jax_failover.state_digest(jax_failover.recover(_jax_log(plog))) == want


def _manifest(pkg, n_units=3, unit_bytes=64):
    meta, unit, man = {"jax": (JaxMeta, JaxUnit, JaxManifest), "port": (PortMeta, PortUnit, PortManifest)}[pkg]
    tensors = tuple(meta(f"t{i}", (unit_bytes,), "uint8", unit_bytes) for i in range(n_units))
    units = tuple(unit(index=i, name=f"t{i}", nbytes=unit_bytes) for i in range(n_units))
    return man(tensors=tensors, units=units, checksums=(0,) * n_units)


def _open_replica(pkg, s, name, shards=2, dc="dc0"):
    info = {"jax": JaxWorkerInfo, "port": PortWorkerInfo}[pkg]
    for i in range(shards):
        s.open("m", name, shards, i, worker=info(f"{name}/s{i}", f"{dc}/{name}", dc, False))
        s.register("m", name, i)


def _both(fn):
    """Run ``fn(pkg, server, log)`` on a fresh logged server of each
    package; return ``{pkg: (server, log, fn's result)}``."""
    out = {}
    for pkg, core, oplog in (("jax", jax_core, JaxOpLog), ("port", port_core, PortOpLog)):
        log = oplog()
        s = core.ReferenceServer(log=log)
        out[pkg] = (s, log, fn(pkg, s, log))
    return out


def test_compaction_truncates_history():
    def drive(pkg, s, log):
        failover = {"jax": jax_failover, "port": port_failover}[pkg]
        _open_replica(pkg, s, "pub")
        for i in range(2):
            s.publish("m", "pub", i, 0, _manifest(pkg), op_id=0)
        log.compact(failover.take_snapshot(s))
        assert list(log.committed(after=log.snapshot.seq)) == []
        rec = failover.recover(log)
        assert failover.state_digest(rec) == failover.state_digest(s)
        _open_replica(pkg, rec, "r")
        rec.begin_replicate("m", "r", 0, "latest", op_id=0)
        rec.begin_replicate("m", "r", 1, "latest", op_id=0)
        assert failover.state_digest(failover.recover(log)) == failover.state_digest(rec)
        return rec

    out = _both(drive)
    (_, jlog, jrec), (_, plog, prec) = out["jax"], out["port"]
    assert port_failover.state_digest(prec) == jax_failover.state_digest(jrec)
    assert plog.to_jsonl() == jlog.to_jsonl()  # the compacted WAL images are the same bytes


@pytest.mark.parametrize("redeliver", ["complete_replicate", "publish", "poll_events"])
def test_redelivery_is_a_noop_in_both(redeliver):
    def drive(pkg, s, log):
        failover = {"jax": jax_failover, "port": port_failover}[pkg]
        _open_replica(pkg, s, "pub")
        _open_replica(pkg, s, "r")
        for i in range(2):
            s.publish("m", "pub", i, 0, _manifest(pkg), op_id=0)
        for i in range(2):
            s.begin_replicate("m", "r", i, 0, op_id=0)
        for i in range(2):
            s.update_progress("m", "r", i, 0, 3)
        for i in range(2):
            s.complete_replicate("m", "r", i, 0, op_id=1)
        before = failover.state_digest(s)
        stats = dict(s.stats)
        if redeliver == "complete_replicate":
            for i in range(2):
                s.complete_replicate("m", "r", i, 0, op_id=1)
        elif redeliver == "publish":
            for i in range(2):
                s.publish("m", "pub", i, 0, _manifest(pkg), op_id=0)
        else:
            s.fail_replica("m", "pub", reason="emit events")
            assert s.poll_events("pub/s0")
            before = failover.state_digest(s)
            stats = dict(s.stats)
            assert s.poll_events("pub/s0") == []
        assert s.stats == stats
        assert failover.state_digest(s) == before

    out = _both(drive)
    assert port_failover.state_digest(out["port"][0]) == jax_failover.state_digest(out["jax"][0])
    assert out["port"][1].to_jsonl() == out["jax"][1].to_jsonl()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_written_by_one_package_recovers_in_the_other(tmp_path, writer):
    """A controller of one package takes a recorded trace into its WAL
    file and dies; the other package's ``recover_path`` rebuilds the same
    digest and keeps appending; the first package recovers the grown file
    again."""
    pkgs = {"jax": (jax_core, jax_failover, JaxOpLog), "port": (port_core, port_failover, PortOpLog)}
    other = "port" if writer == "jax" else "jax"
    (wcore, wfail, wlog), (_, ofail, _) = pkgs[writer], pkgs[other]
    trace = JaxOpLog()
    _random_trace(jax_core.ReferenceServer(heartbeat_timeout=10.0, log=trace), random.Random(5), n_ops=40)
    wal = str(tmp_path / "controller.wal")
    live = wcore.ReferenceServer(heartbeat_timeout=10.0, log=wlog.open_path(wal))
    for rec in wlog.from_jsonl(trace.to_jsonl()).committed():
        wfail.apply_record(live, rec)
    live.log.close()
    rec = ofail.recover_path(wal)
    assert ofail.state_digest(rec) == wfail.state_digest(live)
    assert rec.log.path == wal
    _open_replica(other, rec, "late")
    rec.publish("m", "late", 0, 99, _manifest(other), op_id=77)
    grown = ofail.state_digest(rec)
    rec.log.close()
    again = wfail.recover_path(wal)
    assert wfail.state_digest(again) == grown
    again.log.close()


# ---------------------------------------------------------------------------
# threaded crash recovery through the port's client (real bytes, CPU stores)
# ---------------------------------------------------------------------------

BIG = 3 * 1024 * 1024  # above the 2 MiB compaction threshold: a unit a tensor


def _big_tensors(seed, n=5):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.integers(0, 255, size=BIG, dtype=np.uint8) for i in range(n)}


def _group(hub, name, make, shards=1):
    hs = [hub.open("m", name, shards, i) for i in range(shards)]
    for h in hs:
        h.register(make())
    return hs


def _run_threads(handles, fn):
    errs = []

    def wrap(h):
        try:
            fn(h)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(h,)) for h in handles]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    if errs:
        raise errs[0]


@pytest.mark.parametrize("tail_loss", [False, True])
def test_threaded_crash_mid_pull_resumes_byte_identical(tail_loss):
    """The port's controller dies while two readers pull (and, with
    ``tail_loss``, loses the unflushed group-commit tail: the readers'
    whole sessions); after ``hub.failover(recover(log))`` both finish with
    the publisher's exact bytes, as the JAX package's client does."""
    log = PortOpLog(group_commit=1_000_000 if tail_loss else 1)
    hub = port_core.TensorHubClient(port_core.ReferenceServer(log=log), failover_timeout=15.0, device="cpu")
    state = {"progress": 0, "crashed": False, "lost": 0}

    def make(seed):
        return lambda: {k: torch.from_numpy(v) for k, v in _big_tensors(seed).items()}

    pubs = _group(hub, "pub", make(1))
    _run_threads(pubs, lambda h: h.publish(0))
    log.flush()

    def hook(rec):
        if rec.op != "update_progress" or state["crashed"]:
            return
        state["progress"] += 1
        if state["progress"] == 3:
            state["crashed"] = True
            state["lost"] = log.lose_tail() if tail_loss else 0
            hub.server.crash()
            hub.failover(port_failover.recover(log))

    readers = _group(hub, "r1", make(2)) + _group(hub, "r2", make(3))
    log.on_append = hook
    got = []
    _run_threads(readers, lambda h: got.append(h.replicate("latest")))
    assert state["crashed"] and got == [0, 0]
    assert (state["lost"] > 0) == tail_loss
    want = _big_tensors(1)
    for h in readers:
        for name, arr in want.items():
            assert h.store.get(name).numpy().tobytes() == arr.tobytes(), (h.replica, name)
    assert set(hub.server.list_versions("m")[0]) >= {"pub", "r1", "r2"}


def test_lost_publish_reasserted():
    """The recovered server lost the publish itself: the port's handles
    vouch for their registered bytes again, and a later reader is served
    correctly."""
    log = PortOpLog(group_commit=1_000_000)
    hub = port_core.TensorHubClient(port_core.ReferenceServer(log=log), failover_timeout=15.0, device="cpu")
    pubs = _group(hub, "pub", lambda: {k: torch.from_numpy(v) for k, v in _big_tensors(11).items()}, shards=2)
    log.flush()
    _run_threads(pubs, lambda h: h.publish(0))
    with hub._cv:  # noqa: SLF001 — test harness
        assert log.lose_tail() > 0
        hub.server.crash()
        hub.failover(port_failover.recover(log))
    assert hub.server.latest("m") == 0
    r = _group(hub, "r", lambda: {k: torch.zeros(BIG, dtype=torch.uint8) for k in _big_tensors(11)}, shards=2)
    _run_threads(r, lambda h: h.replicate(0))
    for h, p in zip(r, pubs):
        for name, t in p.store.tensors().items():
            assert torch.equal(h.store.get(name), t)
