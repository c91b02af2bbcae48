"""The port's discrete-event simulator against the JAX package's, on the CPU.

Each scenario is one builder that takes a package (the ``repro`` or the
``repro_torch`` modules) and returns what the simulator reports: the
virtual clock, each reader's stall, the stall decomposition, the bytes a
link class carried, the server's ``state_digest`` and, with
``telemetry=True``, the recorded spans, their Chrome trace export and the
counters. The two simulators
do the same Python arithmetic over byte-compatible control planes, so the
two reports must be equal with ``==``, floats included: any difference is
a fault of the port.

The scenarios: every ``SimCluster`` scenario of ``tests/test_simcluster.py``
(single flow, fair share, rate cap, pipeline and its contention, failure
masking, cross-DC raw / int8 / the deprecated ``tcp_compression`` alias,
multi-source, the ``window=1`` replay, chunking, a source death mid
windowed pull, the safety tick); every scenario of ``chip_smoke.py``
phase 13, built by its own builders (Table 3's 9B, 36B and 260B
standalone for two steps, 260B elastic at 1 and 6 spot replicas, 9B
cross-DC seeding in raw, int8 and delta:int8, a TP-4 -> TP-2 resharded
int8 pull); a ``FaultPlan`` of crash, slow, hang, flaky and
corrupt faults through ``install_faults``; an op-boundary crash sweep
through ``crash_and_recover``; small random clusters (a property test).

The port's one device constant, the drain rate of a resharded lossy
pull's fused decode (a third of the ``H100`` profile's HBM rate), is
patched to the JAX package's 819 GB/s for the parity scenarios; the true
profile changes only the ``decode`` part of such a pull, and shrinks it.
"""

import dataclasses
import importlib
import importlib.util
import math
import sys
import types
import warnings
from pathlib import Path

import pytest

from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")


def _chip_smoke():
    """``chip_smoke.py``, whose phase 13 builds Table 3's scenarios: the
    parity tests run those builders on both simulators."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _chip_smoke()

GB = 1e9
#: the JAX package's drain rate of the fused decode: its profile's HBM rate
JAX_HBM_BW = 819e9


def pkg(root: str) -> types.SimpleNamespace:
    """The simulator's modules of one package."""

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        root=root, sc=mod("transfer.simcluster"), net=mod("transfer.simnet"), faults=mod("transfer.faults"),
        failover=mod("core.failover"), oplog=mod("core.oplog"), meta=mod("core.meta"),
        codec=mod("transfer.codec"), export=mod("obs.export"), workloads=mod("configs.paper_workloads").WORKLOADS,
    )


@pytest.fixture
def both(monkeypatch):
    """The two packages, the port's drain rate at the JAX package's."""
    port = pkg("repro_torch")
    hw = importlib.import_module("repro_torch.transfer.hardware")
    monkeypatch.setattr(port.sc, "H100", hw.GpuHW(hbm_bw=JAX_HBM_BW))
    return pkg("repro"), port


def report(P, cl, names, **extra) -> dict:
    """What a run of ``cl`` reports about the readers ``names``."""
    return dict(
        now=cl.env.now,
        stalls=cl.per_worker_stalls(names),
        decomposition=cl.stall_decomposition(names),
        link_bytes=cl.link_class_bytes(),
        delivered=cl.net.bytes_delivered,
        digest=P.failover.state_digest(cl.server),
        stats=dict(cl.server.stats),
        spans=list(cl.recorder.events),
        trace=P.export.chrome_trace_events(cl.recorder),
        counters=dict(cl.recorder.counters),
        **extra,
    )


def done(ev) -> bool:
    return bool(ev.triggered) and ev.error is None


# -- the scenarios of tests/test_simcluster.py ------------------------------------


def simnet_single_flow(P):
    env = P.net.SimEnv()
    net = P.net.SimNetwork(env)
    a, b = net.link("a", 10e9), net.link("b", 10e9)
    ev = net.flow(20e9, [a, b])
    env.run()
    return dict(now=env.now, done=ev.triggered, link_bytes=dict(net.link_bytes), delivered=net.bytes_delivered)


def simnet_fair_share(P):
    env = P.net.SimEnv()
    net = P.net.SimNetwork(env)
    shared = net.link("s", 10e9)
    evs = [net.flow(10e9, [shared]), net.flow(7e9, [shared])]
    env.run()
    return dict(now=env.now, done=[e.triggered for e in evs], delivered=net.bytes_delivered)


def simnet_rate_cap(P):
    env = P.net.SimEnv()
    net = P.net.SimNetwork(env)
    lk = net.link("l", 100e9)
    net.flow(10e9, [lk], rate_cap=5e9)
    net.flow(3e9, [lk])
    env.run()
    return dict(now=env.now, delivered=net.bytes_delivered)


def _published(P, n_rollouts, **kw):
    cl = P.sc.SimCluster(**kw)
    units = [GB] * 10
    tr = cl.add_replica("m", "tr", 8, unit_bytes=units)
    ros = [cl.add_replica("m", f"ro{i}", 8, unit_bytes=units) for i in range(n_rollouts)]
    tr.open()
    for r in ros:
        r.open()
    cl.run()
    tr.publish(0)
    cl.run()
    return cl, ros


def pipeline(P):
    cl, ros = _published(P, 4, telemetry=True)
    evs = [r.replicate("latest") for r in ros]
    cl.run()
    return report(P, cl, [r.name for r in ros], done=[done(e) for e in evs])


def no_pipeline_contention(P):
    cl, ros = _published(P, 4, pipeline_replication=False)
    for r in ros:
        r.replicate("latest")
    cl.run()
    return report(P, cl, [r.name for r in ros])


def failure_masking(P):
    cl, ros = _published(P, 2, telemetry=True)
    evs = [r.replicate("latest") for r in ros]
    cl.env.schedule(0.15, lambda: cl.kill_replica("ro0"))
    cl.run()
    return report(P, cl, ["ro1"], done=done(evs[1]))


def _cross_dc(P, **kw):
    cl = P.sc.SimCluster(**kw)
    units = [GB] * 10
    tr = cl.add_replica("m", "tr", 2, datacenter="dc0", unit_bytes=units)
    ros = [cl.add_replica("m", f"ro{i}", 2, datacenter="dc1", unit_bytes=units) for i in range(3)]
    tr.open()
    for r in ros:
        r.open()
    cl.run()
    tr.publish(0)
    cl.run()
    for r in ros:
        r.replicate("latest")
    cl.run()
    vpc_up = sum(b for n, b in cl.net.link_bytes.items() if ":vpc_up" in n)
    return report(P, cl, [r.name for r in ros], vpc_up=vpc_up)


def cross_dc_raw(P):
    return _cross_dc(P, wan_codec="raw")


def cross_dc_int8(P):
    rep = _cross_dc(P, telemetry=True)
    rep["int8_ratio"] = P.codec.wire_ratio(P.codec.get_codec("int8"), [int(GB)] * 10, "float32")
    return rep


def cross_dc_tcp_compression_alias(P):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = _cross_dc(P, tcp_compression=0.5)
    rep["warned"] = [str(w.category.__name__) for w in caught if issubclass(w.category, DeprecationWarning)]
    return rep


def _fanout(P, n_dest, m_src, units, **kw):
    cl = P.sc.SimCluster(**kw)
    pubs = [cl.add_replica("m", f"pub{i}", 2, unit_bytes=units) for i in range(m_src)]
    dests = [cl.add_replica("m", f"dst{i}", 2, unit_bytes=units) for i in range(n_dest)]
    for r in pubs + dests:
        r.open()
    cl.run()
    pubs[0].publish(0)
    cl.run()
    for p in pubs[1:]:
        p.replicate("latest")
    cl.run()
    t0 = cl.env.now
    evs = [d.replicate("latest") for d in dests]
    cl.run()
    return report(P, cl, [d.name for d in dests], t0=t0, done=[done(e) for e in evs])


def multi_source(P):
    return _fanout(P, 2, 3, [GB] * 8, telemetry=True)


def pinned_baseline(P):
    return _fanout(P, 8, 4, [GB] * 8, window=1, chunk_bytes=None, max_sources=1, scheduler="pinned",
                   pipeline_replication=False)


def window1_replay(P):
    return _fanout(P, 1, 1, [GB] * 16, window=1, chunk_bytes=None, max_sources=1)


def chunking(P):
    return _fanout(P, 2, 3, [12 * GB], chunk_bytes=GB)


def source_death_mid_windowed_pull(P):
    cl = P.sc.SimCluster(telemetry=True)
    units = [GB] * 12
    pubs = [cl.add_replica("m", f"pub{i}", 2, unit_bytes=units) for i in range(3)]
    dst = cl.add_replica("m", "dst", 2, unit_bytes=units)
    for r in pubs + [dst]:
        r.open()
    cl.run()
    pubs[0].publish(0)
    cl.run()
    for p in pubs[1:]:
        p.replicate("latest")
    cl.run()
    ev = dst.replicate("latest")
    cl.env.schedule(0.15, lambda: cl.kill_replica("pub1"))
    cl.run()
    return report(P, cl, ["dst"], done=done(ev))


def safety_tick(P):
    env = P.net.SimEnv()
    woken = []

    def waiter():
        yield env.key_wait("never-notified")
        woken.append(env.now)

    env.process(waiter())
    env.run(until=100.0)
    net_env = P.net.SimEnv()
    net = P.net.SimNetwork(net_env)
    link = net.link("l", 10e9)

    def proc():
        yield net_env.key_wait("k")
        yield net.flow(10e9, [link])

    net_env.process(proc())
    net_env.schedule(0.5, lambda: net_env.key_notify("k"))
    net_env.run()
    return dict(woken=woken, tick=env.safety_tick, now=env.now, healthy_now=net_env.now)


# -- Table 3 (Fig. 9 and 11) ---------------------------------------------------------------


def table3(P, build, *args, **kw):
    """A Table 3 scenario as ``chip_smoke.py`` phase 13 builds it, on the
    simulator of ``P``: what it reports, and whether every reader ended at
    the published version."""
    cl, readers, version, extra = build(P.sc, *args, **kw)
    names = [r.name for r in readers]
    return report(P, cl, names, done=[cl.server.replica_version("m", n) == version for n in names], **extra)


def reshard_int8(P):
    """``benchmarks/reshard.py``'s ``_sim_reshard``: TP-4 (dc0) -> TP-2
    (dc1) over int8 frames, reaching the fused decode's drain."""
    return table3(P, smoke.sim_reshard, P.workloads["36B"], telemetry=True)


# -- faults and failover --------------------------------------------------------------------


def fault_plan(P):
    """A seeded plan of every sim fault kind against the pipeline's middle
    replica, a crash of a spare and of the controller (``benchmarks/
    chaos.py``'s trainer -> ra -> rb, with an op log to recover from)."""
    F = P.faults
    policy = F.RetryPolicy(fail_detect=0.1, retry_limit=4, retry_backoff=0.02, hedge_threshold=3.0,
                           hedge_min_samples=2)
    cl = P.sc.SimCluster(retry_policy=policy, telemetry=True, quarantine_threshold=2, quarantine_probation=5.0,
                         log=P.oplog.OpLog())
    units = [GB] * 6
    reps = {n: cl.add_replica("m", n, 2, unit_bytes=units) for n in ("trainer", "ra", "rb", "rc", "spare")}
    for r in reps.values():
        r.open()
    cl.run()
    reps["trainer"].publish(0)
    cl.run()
    reps["spare"].replicate("latest")
    cl.run()
    cl.install_faults(F.FaultPlan(seed=7, faults=(
        F.FaultSpec("slow", "ra", start=0.0, duration=0.3, severity=0.05, direction="up"),
        F.FaultSpec("hang", "ra", start=0.3, duration=0.2, direction="up"),
        F.FaultSpec("flaky", "ra", severity=0.25),
        F.FaultSpec("corrupt", "rc", severity=1.0),
        F.FaultSpec("crash", "spare", start=0.05),
        F.FaultSpec("crash", F.CONTROLLER, start=0.12),
    )))
    evs = [reps[n].replicate("latest") for n in ("ra", "rb", "rc")]
    cl.run()
    info = {name: (i.quarantined_until, i.suspect_strikes, i.failed)
            for name, i in sorted(cl.server._models["m"].replicas.items())}  # noqa: SLF001
    parts = [(f"{r}/{i}", sorted(w.stall_parts.items()), w.total_stall) for (r, i), w in sorted(cl._workers.items())]  # noqa: SLF001
    return report(P, cl, ["ra", "rb", "rc"], done=[done(e) for e in evs], workers=info, parts=parts,
                  records=cl.log.last_seq)


def _crash_trace(P, crash_at=None, snapshot_every=None):
    """``tests/test_failover.py``'s ``_sim_trace``: publish -> replicate x2
    -> roll the version -> update x2, the controller crashed and recovered
    from its op log at record ``crash_at``."""
    log = P.oplog.OpLog()
    cl = P.sc.SimCluster(log=log, control_latency=0.001)
    fired = []

    def hook(rec):
        if snapshot_every is not None and rec.seq % snapshot_every == 0 and not cl.server.is_crashed:
            log.compact(P.failover.take_snapshot(cl.server, seq=rec.seq - 1))
        if crash_at is not None and rec.seq >= crash_at and not fired:
            fired.append(rec.seq)
            cl.crash_and_recover()

    log.on_append = hook
    units = [GB] * 4
    pub, r1, r2 = (cl.add_replica("m", n, 2, unit_bytes=units) for n in ("pub", "r1", "r2"))
    for r in (pub, r1, r2):
        r.open()
    cl.run()
    pub.publish(0)
    cl.run()
    evs = [r1.replicate("latest"), r2.replicate("latest")]
    cl.run()
    evs += [r1.unpublish(), r2.unpublish()]
    cl.run()
    pub2 = cl.add_replica("m", "pub2", 2, unit_bytes=units)
    pub2.open()
    cl.run()
    pub2.publish(1)
    cl.run()
    evs += [r1.update("latest"), r2.update("latest")]
    cl.run(until=300.0)
    cl.server.attach_log(None)
    return report(P, cl, ["r1", "r2"], done=[done(e) for e in evs], fired=fired, records=log.last_seq)


def crash_sweep(P):
    """A crash at every fourth op boundary of the trace, and two with
    snapshot compaction."""
    base = _crash_trace(P)
    out = [base]
    for k in range(1, base["records"] + 1, 4):
        out.append(_crash_trace(P, crash_at=k))
    for k in (7, 29):
        out.append(_crash_trace(P, crash_at=k, snapshot_every=10))
    return out


SCENARIOS = {
    "simnet_single_flow": simnet_single_flow,
    "simnet_fair_share": simnet_fair_share,
    "simnet_rate_cap": simnet_rate_cap,
    "pipeline": pipeline,
    "no_pipeline_contention": no_pipeline_contention,
    "failure_masking": failure_masking,
    "cross_dc_raw": cross_dc_raw,
    "cross_dc_int8": cross_dc_int8,
    "cross_dc_tcp_compression_alias": cross_dc_tcp_compression_alias,
    "multi_source": multi_source,
    "pinned_baseline": pinned_baseline,
    "window1_replay": window1_replay,
    "chunking": chunking,
    "source_death_mid_windowed_pull": source_death_mid_windowed_pull,
    "safety_tick": safety_tick,
    **{f"standalone_{n}": lambda P, n=n: table3(P, smoke.sim_standalone, P.workloads[n])
       for n in smoke.SIM_STANDALONE},
    **{f"elastic_260B_{k}": lambda P, k=k: table3(P, smoke.sim_elastic, P.workloads["260B"], k)
       for k in smoke.SIM_ELASTIC},
    **{f"cross_dc_9B_{c}": lambda P, kw=kw: table3(P, smoke.sim_cross_dc, P.workloads["9B"], **kw)
       for c, kw in smoke.SIM_CROSS_DC.items()},
    "reshard_tp4_tp2_int8": reshard_int8,
    "fault_plan": fault_plan,
    "crash_sweep": crash_sweep,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_port_reports_what_the_jax_simulator_reports(both, scenario):
    jax_pkg, port_pkg = both
    want = SCENARIOS[scenario](jax_pkg)
    got = SCENARIOS[scenario](port_pkg)
    assert got == want


def test_scenarios_reach_what_they_are_about(both):
    """The parity above is not vacuous: the scenarios end as
    ``tests/test_simcluster.py`` says they do, on the port."""
    _, P = both
    assert math.isclose(simnet_single_flow(P)["now"], 2.0, rel_tol=1e-6)
    pipe, contended = pipeline(P), no_pipeline_contention(P)
    assert all(pipe["done"]) and max(pipe["stalls"]) < 1.25 * min(pipe["stalls"]) + 0.5
    assert max(contended["stalls"]) > 3.0 * 10 * GB / (0.92 * 25e9)
    assert failure_masking(P)["done"]
    raw, int8, alias = cross_dc_raw(P), cross_dc_int8(P), cross_dc_tcp_compression_alias(P)
    assert math.isclose(raw["vpc_up"], 10 * GB * 2, rel_tol=1e-6)
    assert int8["int8_ratio"] < 0.26 and math.isclose(int8["vpc_up"], 10 * GB * 2 * int8["int8_ratio"], rel_tol=1e-6)
    assert alias["warned"] and math.isclose(alias["vpc_up"], 10 * GB * 2 * 0.5, rel_tol=1e-6)
    multi = multi_source(P)
    assert multi["stats"]["multi_source_assignments"] >= 1 and all(multi["done"])
    w1 = window1_replay(P)
    assert math.isclose(w1["now"] - w1["t0"], 0.6984521739, rel_tol=1e-6)
    assert chunking(P)["stats"]["multi_source_assignments"] >= 2
    death = source_death_mid_windowed_pull(P)
    assert death["done"] and death["stats"]["reassignments"] >= 1
    tick = safety_tick(P)
    assert tick["woken"] == [tick["tick"]] and math.isclose(tick["healthy_now"], 1.5, rel_tol=1e-6)
    rs = reshard_int8(P)
    assert rs["done"] and rs["decomposition"]["decode"] > 0
    fp = fault_plan(P)
    assert all(fp["done"]) and fp["stats"]["quarantines"] >= 1
    assert any(name == "decode" or "flow" in name for name, *_ in fp["spans"]) and fp["trace"]
    sweep = crash_sweep(P)
    assert all(all(r["done"]) for r in sweep) and all(r["fired"] for r in sweep[1:])
    assert {r["digest"] for r in sweep} == {sweep[0]["digest"]}  # every recovery converges to the uncrashed state


@settings(max_examples=12, deadline=None)
@given(
    replicas=st.integers(1, 4),
    shards=st.integers(1, 3),
    units=st.lists(st.integers(1, 40), min_size=1, max_size=5),
    window=st.integers(1, 4),
    chunk=st.sampled_from([None, 0.5 * GB, 2 * GB]),
    codec=st.sampled_from(["raw", "int8", "delta:int8"]),
    cross_dc=st.booleans(),
)
def test_random_clusters_agree(replicas, shards, units, window, chunk, codec, cross_dc):
    """Small random clusters (replicas, shards, unit sizes in units of 0.1
    GB, window, chunk bytes, WAN codec, a second datacenter or not):
    publish v0, replicate everywhere, roll to v1, update everywhere."""
    port = pkg("repro_torch")
    hw = importlib.import_module("repro_torch.transfer.hardware")
    saved = port.sc.H100
    port.sc.H100 = hw.GpuHW(hbm_bw=JAX_HBM_BW)
    try:
        reports = []
        for P in (pkg("repro"), port):
            cl = P.sc.SimCluster(window=window, chunk_bytes=chunk, wan_codec=codec)
            sizes = [int(u * 0.1 * GB) for u in units]
            tr = cl.add_replica("m", "tr", shards, unit_bytes=sizes)
            ros = [cl.add_replica("m", f"ro{i}", shards, datacenter="dc1" if cross_dc and i % 2 == 0 else "dc0",
                                  unit_bytes=sizes) for i in range(replicas)]
            for r in [tr] + ros:
                r.open()
            cl.run()
            evs = []
            for v in range(2):
                tr.publish(v)
                cl.run()
                evs += [(r.replicate if v == 0 else r.update)("latest") for r in ros]
                cl.run()
                tr.unpublish()
                cl.run()
            reports.append(report(P, cl, [r.name for r in ros], done=[done(e) for e in evs]))
    finally:
        port.sc.H100 = saved
    assert all(reports[1]["done"])
    assert reports[1] == reports[0]


def test_the_h100_profile_moves_only_the_decode_part(both):
    """The true profile (3.35 TB/s, a drain of ~1.12 TB/s) against the
    JAX package's 819 GB/s on the resharded int8 pull: only the ``decode``
    part of the stall changes, and it shrinks; the wire bytes stay."""
    _, P = both
    at_819 = reshard_int8(P)
    hw = importlib.import_module("repro_torch.transfer.hardware")
    P.sc.H100 = hw.H100
    at_h100 = reshard_int8(P)
    assert at_h100["done"] and at_819["done"]
    d0, d1 = at_819["decomposition"], at_h100["decomposition"]
    assert 0 < d1["decode"] < d0["decode"]
    assert {k: v for k, v in d1.items() if k != "decode"} == {k: v for k, v in d0.items() if k != "decode"}
    assert at_h100["link_bytes"] == at_819["link_bytes"]
    moved = sum(at_h100["stalls"]) - sum(at_819["stalls"])  # over both of the reader's shards
    assert moved == pytest.approx(d1["decode"] - d0["decode"], abs=1e-9)


def test_h100_profile_is_the_data_sheets():
    hw = importlib.import_module("repro_torch.transfer.hardware")
    assert dataclasses.asdict(hw.H100) == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12, "nvlink_bw": 450e9}
    assert not hasattr(hw, "TPU") and not hasattr(hw, "TpuHW")
    assert dataclasses.asdict(hw.CLUSTER) == dataclasses.asdict(importlib.import_module("repro.transfer.hardware").CLUSTER)


def test_simulator_builds_no_kernel(monkeypatch):
    """The simulator touches no tensor: a scenario over every codec runs
    with the kernel build refusing to start."""
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("the simulator reached the kernel build")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "library", refuse)
    P = pkg("repro_torch")
    assert reshard_int8(P)["done"]
    assert cross_dc_int8(P)["vpc_up"] > 0
    sizes = [P.sc._sim_dtype(n, dt) for n, dt in ((8, "float32"), (6, "float32"), (6, "bfloat16"), (7, "float16"))]
    ref = importlib.import_module("repro.transfer.simcluster")
    assert sizes == [ref._sim_dtype(n, dt) for n, dt in ((8, "float32"), (6, "float32"), (6, "bfloat16"),
                                                          (7, "float16"))]
    assert sizes == [("float32", 4), ("uint8", 1), ("bfloat16", 2), ("uint8", 1)]
