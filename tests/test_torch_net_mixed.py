"""The mixed cluster: JAX-package and port workers pulling from each other
through one networked controller, in one process over localhost sockets.

A controller of either package (``ReferenceService`` behind a
``ControlServer``, each in a thread) serves a publisher ``NetWorker`` of
one package and reader ``NetWorker``s of the other (the port's at
``device="cpu"``), each with its own registry, so every read crosses a
socket between the packages. Raw, int8 and ``delta:int8`` pulls, and a
TP-2 -> TP-1 resharded pull (raw, and int8 through ``raw_wire`` frames),
in f32 and bf16, must leave replicas, manifests, checksums and wire-byte
counts bit-equal to the same scenario run in process through the JAX
package alone. A port controller restarted from its WAL mid-pull
(``recover_path``, a new port in the address file) must let the pull
resume to the same bytes.

The JAX side's int8 is pinned to its NumPy branch, the byte oracle (its
XLA branch may round a scale 1 ulp apart, which is legal but not
byte-equal).
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import repro.core as jax_core  # noqa: E402
import repro.core.oplog as jax_oplog  # noqa: E402
import repro.net.client as jax_netclient  # noqa: E402
import repro.net.httpd as jax_httpd  # noqa: E402
import repro.net.service as jax_service  # noqa: E402
import repro.net.worker as jax_worker  # noqa: E402
import repro.resharding as jax_resharding  # noqa: E402
import repro.transfer.codec as jax_codec  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.failover as port_failover  # noqa: E402
import repro_torch.core.oplog as port_oplog  # noqa: E402
import repro_torch.net.client as port_netclient  # noqa: E402
import repro_torch.net.httpd as port_httpd  # noqa: E402
import repro_torch.net.service as port_service  # noqa: E402
import repro_torch.net.worker as port_worker  # noqa: E402
import repro_torch.resharding as port_resharding  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402

CHUNK = 1 << 20  # units above it are pulled as 1 MiB chunks (range reads)
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}

JAX = types.SimpleNamespace(
    name="jax", core=jax_core, worker=jax_worker, service=jax_service, httpd=jax_httpd,
    netclient=jax_netclient, oplog=jax_oplog, resharding=jax_resharding,
    kw={}, tensors=lambda w: {k: np.array(a, copy=True) for k, a in w.items()},
    copy=lambda a: np.ascontiguousarray(a).copy(),
    assign=lambda dst, src: dst.__setitem__(Ellipsis, src),
)
PORT = types.SimpleNamespace(
    name="port", core=port_core, worker=port_worker, service=port_service, httpd=port_httpd,
    netclient=port_netclient, oplog=port_oplog, resharding=port_resharding,
    kw={"device": "cpu"}, tensors=lambda w: from_numpy(w, "cpu"),
    copy=lambda t: t.contiguous().clone(),
    assign=lambda dst, src: dst.copy_(src),
)
OTHER = {"jax": PORT, "port": JAX}


@pytest.fixture(autouse=True)
def numpy_int8_backend(monkeypatch):
    monkeypatch.setattr(jax_codec.Int8Codec, "_resolve_jax", lambda self: None)


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).view(np.uint8).tobytes()


def _weights(dtype: str, seed: int = 0):
    """v0 and v1 (1/8 of each tensor's 256-element rows perturbed): one
    tensor above the chunk size (a unit of its own, pulled in chunks)
    and two that compact into one bucket."""
    rng = np.random.default_rng(seed)
    shapes = {"big": (1024, 1536), "mid": (512, 1100), "b": (96,)}
    v0, v1 = {}, {}
    for name, shape in shapes.items():
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        w1 = w.reshape(-1).copy()
        for r in range(0, -(-w1.size // 256), 8):
            seg = slice(r * 256, min((r + 1) * 256, w1.size))
            w1[seg] += rng.standard_normal(w1[seg].size).astype(np.float32) * 0.01
        v0[name] = w.astype(DTYPES[dtype])
        v1[name] = w1.reshape(shape).astype(DTYPES[dtype])
    return v0, v1


class Controller:
    """One package's controller behind a ControlServer, in a thread."""

    def __init__(self, pkg, *, wal=None, addr_file=None):
        self.pkg = pkg
        log = pkg.oplog.OpLog.open_path(wal) if wal else None
        self.server = pkg.core.ReferenceServer(log=log)
        self.http = pkg.httpd.ControlServer(pkg.service.ReferenceService(self.server)).start()
        if addr_file:
            pkg.netclient.write_address(addr_file, self.http.address)

    @property
    def address(self):
        return self.http.address

    def stop(self):
        self.http.shutdown()
        if self.server.log is not None:
            self.server.log.close()


def _worker(pkg, wid, ctrl, **kw):
    where = {"addr_file": kw.pop("addr_file")} if "addr_file" in kw else {"address": ctrl.address}
    return pkg.worker.NetWorker(wid, chunk_bytes=CHUNK, rpc_timeout=20.0, **where, **pkg.kw, **kw)


def run_group(fns, timeout=60.0):
    errs = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(fn,), daemon=True) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "a pull did not finish in time"
    if errs:
        raise errs[0]


# ---------------------------------------------------------------------------
# the scenarios: one body, run in process (the oracle) or networked
# ---------------------------------------------------------------------------


def _same_layout(pub_pkg, read_pkg, open_pub, open_read, v0, v1, delta=True):
    """trainer (dc0) publishes v0; r0 (dc0, raw) and r1 (dc1, int8)
    replicate; the trainer unpublishes, writes v1 in place and publishes;
    (with ``delta``) r1 updates over delta:int8, then r0 raw: r1 first,
    while the trainer alone holds v1, so its source is the publisher."""
    trainer = open_pub("m", "trainer", 1, 0, datacenter="dc0")
    trainer.register(pub_pkg.tensors(v0))
    trainer.publish(0)
    zeros = {k: np.zeros_like(v) for k, v in v0.items()}
    r0 = open_read(0)("m", "r0", 1, 0, datacenter="dc0")
    r1 = open_read(1)("m", "r1", 1, 0, datacenter="dc1")
    r0.register(read_pkg.tensors(zeros))
    r1.register(read_pkg.tensors(zeros))
    assert r0.replicate(0, timeout=60) == 0
    assert r1.replicate(0, timeout=60) == 0
    trainer.unpublish()
    for name, arr in pub_pkg.tensors(v1).items():
        pub_pkg.assign(trainer.store.get(name), arr)
    trainer.publish(1)
    if delta:
        assert r1.update("latest")
    assert r0.update("latest")
    return {"trainer": trainer, "r0": r0, "r1": r1}


def _resharded(pub_pkg, read_pkg, open_pub, open_read, v0, v1, delta=True):
    """A TP-2 trainer (dc0) publishes v0; a TP-1 replica pulls it raw
    (dc0, staged repack) and one int8 (dc1, wire frames decoded straight
    into place); v1, then both update."""
    tr = [open_pub("m", "trainer", 2, i, datacenter="dc0") for i in range(2)]
    glob = pub_pkg.tensors(v0)
    for h in tr:
        local, lay = pub_pkg.resharding.tp_shard(glob, h.shard_idx, 2)
        h.register({k: pub_pkg.copy(v) for k, v in local.items()}, layout=lay)
    run_group([lambda h=h: h.publish(0) for h in tr])
    full_layout = {k: (tuple(v.shape), (0,) * v.ndim) for k, v in v0.items()}
    zeros = {k: np.zeros_like(v) for k, v in v0.items()}
    rr = open_read(0)("m", "r-raw", 1, 0, datacenter="dc0")
    ri = open_read(1)("m", "r-int8", 1, 0, datacenter="dc1")
    rr.register(read_pkg.tensors(zeros), layout=full_layout)
    ri.register(read_pkg.tensors(zeros), layout=full_layout)
    assert ri.replicate(0, timeout=60) == 0  # while the trainer is the only source
    assert rr.replicate(0, timeout=60) == 0
    run_group([lambda h=h: h.unpublish() for h in tr])
    for h in tr:
        local, _ = pub_pkg.resharding.tp_shard(pub_pkg.tensors(v1), h.shard_idx, 2)
        for name, part in local.items():
            pub_pkg.assign(h.store.get(name), part)
    run_group([lambda h=h: h.publish(1) for h in tr])
    assert ri.update("latest") and rr.update("latest")
    assert rr.intervals_pulled > 0 and ri.intervals_pulled > 0
    return {"trainer0": tr[0], "trainer1": tr[1], "r-raw": rr, "r-int8": ri}


SCENARIOS = {"same_layout": _same_layout, "resharded": _resharded}


def _final(server, handles):
    """Each handle's bytes and its manifest (fields, as tuples: the two
    packages' dataclasses never compare equal as objects)."""
    return {
        key: ({n: _bytes(t) for n, t in h.store.tensors().items()},
              dataclasses.astuple(server.replica_manifest("m", h.current_version, h.replica, h.shard_idx)))
        for key, h in handles.items()
    }


def _in_process(scenario, v0, v1, delta):
    server = jax_core.ReferenceServer()
    hub = jax_core.TensorHubClient(server, chunk_bytes=CHUNK)
    hs = SCENARIOS[scenario](JAX, JAX, hub.open, lambda i: hub.open, v0, v1, delta)
    return _final(server, hs), dict(hub.transport.wire_bytes), dict(server.stats)


def _networked(scenario, ctrl_pkg, pub_pkg, v0, v1, delta):
    read_pkg = OTHER[pub_pkg.name]
    ctrl = Controller(ctrl_pkg)
    pub = _worker(pub_pkg, "pub", ctrl)
    readers = [_worker(read_pkg, f"reader{i}", ctrl) for i in range(2)]
    try:
        hs = SCENARIOS[scenario](pub_pkg, read_pkg, pub.open, lambda i: readers[i].open, v0, v1, delta)
        final = _final(ctrl.server, hs)
        wire = {}
        for r in readers:
            for k, v in r.transport.wire_bytes.items():
                wire[k] = wire.get(k, 0) + v
        stats = [(r.transport.remote_pulls, r.transport.conn_opens, r.transport.conn_reuses,
                  r.transport.delta_stale_fallbacks) for r in readers]
        return final, wire, stats, dict(pub.transport.wire_bytes), dict(ctrl.server.stats)
    finally:
        for w in readers + [pub]:
            w.close()
        ctrl.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scenario", ["same_layout", "resharded"])
@pytest.mark.parametrize("ctrl_name,pub_name", [("jax", "port"), ("port", "jax"), ("port", "port"), ("jax", "jax")])
def test_mixed_cluster_bit_equal(ctrl_name, pub_name, scenario, dtype):
    """Publisher of one package, readers of the other (``port``/``port``
    and ``jax``/``jax`` pairs have readers of the other package too), a
    controller of either: every replica, manifest and checksum equals the
    in-process JAX run, and every reader's bytes crossed a socket."""
    ctrl_pkg = {"jax": JAX, "port": PORT}[ctrl_name]
    pub_pkg = {"jax": JAX, "port": PORT}[pub_name]
    v0, v1 = _weights(dtype)
    # a JAX-package source cannot serve delta:int8 over a socket (see
    # test_jax_source_refuses_delta_int8): its r1 keeps v0
    delta = pub_pkg is PORT
    want, o_wire, o_stats = _in_process(scenario, v0, v1, delta)
    got, wire, stats, pub_wire, server_stats = _networked(scenario, ctrl_pkg, pub_pkg, v0, v1, delta)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key][0] == want[key][0], key  # every tensor's bytes
        assert got[key][1] == want[key][1], key  # the v1 manifest, checksums included
    assert wire == o_wire
    assert pub_wire == {}  # the publisher pulled nothing
    for remote_pulls, opens, reuses, stale in stats:
        assert opens >= 1 and opens + reuses >= 2  # reads crossed a socket, kept alive
        assert stale == 0
    assert server_stats == o_stats


@pytest.mark.parametrize("reader_name", ["jax", "port"])
def test_jax_source_refuses_delta_int8(reader_name):
    """A reference-side fault this file works around: the JAX package's
    data server checksums a delta:int8 frame by decoding it against its
    raw base snapshot (``repro/net/data.py`` ``_serve_read``), whose
    digest is not the frame's (the frame encodes against the snapshot's
    int8 round trip, what the destination holds), so every delta:int8
    read of a JAX source answers StaleBaseError, to a reader of either
    package. The port's data server decodes against the round trip and
    serves the same update (``test_mixed_cluster_bit_equal``)."""
    reader_pkg = {"jax": JAX, "port": PORT}[reader_name]
    v0, v1 = _weights("float32")
    ctrl = Controller(PORT)
    pub = _worker(JAX, "pub", ctrl)
    readers = [_worker(reader_pkg, f"reader{i}", ctrl) for i in range(2)]
    try:
        errors = (jax_codec.StaleBaseError, port_core.TensorHubError)
        with pytest.raises(errors, match="base-version digest mismatch"):
            _same_layout(JAX, reader_pkg, pub.open, lambda i: readers[i].open, v0, v1)
    finally:
        for w in readers + [pub]:
            w.close()
        ctrl.stop()


@pytest.mark.parametrize("pub_name", ["jax", "port"])
def test_controller_restart_mid_pull(tmp_path, pub_name):
    """The port's controller stops mid-pull (its socket closes, as when
    the process dies); a new one recovers from the WAL file
    (``recover_path``) on a new port and publishes it in the address
    file; both workers' ``AddressWatcher``s fail over, and the reader's
    pull, parked meanwhile, resumes to the publisher's exact bytes."""
    pub_pkg = {"jax": JAX, "port": PORT}[pub_name]
    read_pkg = OTHER[pub_name]
    wal, addr = str(tmp_path / "controller.wal"), str(tmp_path / "controller.addr")
    rng = np.random.default_rng(5)
    # six units of their own (above the 2 MiB compaction threshold), each
    # pulled as three chunks
    w = {f"w{i}": rng.standard_normal((768, 768), dtype=np.float32) for i in range(6)}
    total = sum(a.nbytes for a in w.values())
    ctrl = Controller(PORT, wal=wal, addr_file=addr)
    pub = _worker(pub_pkg, "pub", ctrl, addr_file=addr)
    reader = _worker(read_pkg, "reader", ctrl, addr_file=addr, throttle_s=0.15)
    new = None
    try:
        h = pub.open("m", "trainer", 1, 0)
        h.register(pub_pkg.tensors(w))
        h.publish(0)
        r = reader.open("m", "r", 1, 0)
        r.register(read_pkg.tensors({k: np.zeros_like(v) for k, v in w.items()}))
        old_addr = reader.remote().address
        done = []
        t = threading.Thread(target=lambda: done.append(r.replicate(0, timeout=60)), daemon=True)
        t.start()
        deadline = time.monotonic() + 30
        while sum(reader.transport.decoded_bytes.values()) == 0:
            assert time.monotonic() < deadline, "the pull never started"
            time.sleep(0.01)
        ctrl.stop()
        at_stop = sum(reader.transport.decoded_bytes.values())
        recovered = port_failover.recover_path(wal)
        assert recovered.last_recovery_s > 0
        new = port_httpd.ControlServer(port_service.ReferenceService(recovered)).start()
        port_netclient.write_address(addr, new.address)
        t.join(timeout=60)
        assert done == [0], "the pull did not resume after the restart"
        assert at_stop < total  # the stop landed mid-pull
        assert reader.remote().address == new.address != old_addr
        assert pub.remote().address == new.address
        for name, arr in w.items():
            assert _bytes(r.store.get(name)) == _bytes(arr), name
        assert "r" in recovered.list_versions("m")[0]
    finally:
        for wk in (reader, pub):
            wk.close()
        if new is not None:
            new.shutdown()
            recovered.log.close()
