"""The port's networked control plane against the JAX package's, in
process (no sockets): the same frames in, the same bytes out.

* ``encode_request`` / ``encode_result`` / ``encode_error`` give the JAX
  package's bytes for the same op, arguments, results and errors;
* a request frame the JAX package encodes, handed to the port's
  ``ReferenceService``, answers the same response frame, byte for byte,
  as the JAX service answers it — over ``tests/test_net_equivalence.py``'s
  recorded trace and ``tests/test_protocol.py``'s session, with
  ``state_digest`` equal between the port service, an in-process port
  server and the JAX service at every op boundary;
* malformed frames are refused with the same error frames;
* the WAL-file restart of a port controller recovers the same digest;
* ``RpcStats`` and the trace exporters give the same output for the same
  calls and recorder events under a fixed clock.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import errors as jax_errors  # noqa: E402
from repro.core import failover as jax_failover  # noqa: E402
from repro.core.meta import to_wire as jax_to_wire  # noqa: E402
from repro.core.server import ReferenceServer as JaxServer  # noqa: E402
from repro.net import protocol as jax_protocol  # noqa: E402
from repro.net.service import ReferenceService as JaxService  # noqa: E402
from repro.obs import export as jax_export  # noqa: E402
from repro.obs.rpc import RpcStats as JaxRpcStats  # noqa: E402
from repro.obs.telemetry import Recorder as JaxRecorder  # noqa: E402

from repro_torch.core import errors as port_errors  # noqa: E402
from repro_torch.core import failover as port_failover  # noqa: E402
from repro_torch.core.meta import from_wire as port_from_wire  # noqa: E402
from repro_torch.core.oplog import OpLog as PortOpLog  # noqa: E402
from repro_torch.core.server import CONTROL_OPS, ReferenceServer as PortServer  # noqa: E402
from repro_torch.net import protocol as port_protocol  # noqa: E402
from repro_torch.net.client import RemoteClient  # noqa: E402
from repro_torch.net.service import ReferenceService as PortService  # noqa: E402
from repro_torch.obs import export as port_export  # noqa: E402
from repro_torch.obs.rpc import RpcStats as PortRpcStats  # noqa: E402
from repro_torch.obs.telemetry import Recorder as PortRecorder  # noqa: E402

from test_net_equivalence import recorded_trace  # noqa: E402
from test_protocol import session_trace  # noqa: E402


def _port_value(x):
    """A JAX-package value (manifest, worker info...) as the port's own
    object: through the wire codec, as it would cross a socket."""
    return port_from_wire(jax_to_wire(x))


def _port_call(op, args, kw):
    return op, tuple(_port_value(a) for a in args), {k: _port_value(v) for k, v in kw.items()}


class Pair:
    """A JAX and a port ``ReferenceService`` fed the same request frames
    (encoded by the JAX package), plus an in-process port server taking
    the same ops directly."""

    def __init__(self, **cfg):
        self.jax = JaxService(JaxServer(**cfg))
        self.port = PortService(PortServer(**cfg))
        self.direct = PortServer(**cfg)

    def call(self, op, *args, **kw):
        frame = jax_protocol.encode_request(op, args, kw)
        pop, pargs, pkw = _port_call(op, args, kw)
        assert port_protocol.encode_request(pop, pargs, pkw) == frame, op
        want = self.jax.handle_frame(frame)
        got = self.port.handle_frame(frame)
        assert got == want, (op, got, want)
        if not op.startswith("svc."):  # service ops are not server methods
            try:
                getattr(self.direct, op)(*pargs, **pkw)
            except port_errors.TensorHubError:
                pass
        digest = jax_failover.state_digest(self.jax.server)
        assert port_failover.state_digest(self.port.server) == digest, op
        assert port_failover.state_digest(self.direct) == digest, op
        return jax_protocol.decode_response(want)


def test_recorded_trace_same_frames_and_digests():
    pair = Pair(heartbeat_timeout=10.0)
    errors = 0
    for op, args, kw in recorded_trace():
        try:
            pair.call(op, *args, **kw)
        except jax_errors.TensorHubError:
            errors += 1
    assert errors >= 2  # the crash at the end refuses the two ops after it


def test_session_payloads_same_frames():
    pair = Pair()
    results = session_trace(pair.call)
    assert len(results) > 20


@pytest.mark.parametrize("op", sorted(CONTROL_OPS))
def test_encode_request_byte_equal(op):
    args, kw = (1, "x", (2, 3), None, 1.5), {"k": (2, 3), "m": {"a": [1, "b"]}}
    assert port_protocol.encode_request(op, args, kw) == jax_protocol.encode_request(op, args, kw)
    assert port_protocol.decode_request(port_protocol.encode_request(op, args, kw)) == (
        op, [1, "x", (2, 3), None, 1.5], kw
    )


def test_encode_result_byte_equal_over_a_session():
    jax_svc = JaxService(JaxServer())
    results = session_trace(
        lambda op, *a, **k: jax_protocol.decode_response(
            jax_svc.handle_frame(jax_protocol.encode_request(op, a, k))
        )
    )
    for r in results:
        assert port_protocol.encode_result(_port_value(r)) == jax_protocol.encode_result(r)


@pytest.mark.parametrize("kind", sorted(port_protocol.ERROR_TYPES))
def test_encode_error_byte_equal(kind):
    pcls = port_protocol.ERROR_TYPES[kind]
    jcls = jax_protocol.ERROR_TYPES[kind]
    if kind == "TransportError":
        for transient in (False, True):
            pe, je = pcls("boom", transient=transient), jcls("boom", transient=transient)
            assert port_protocol.encode_error(pe) == jax_protocol.encode_error(je)
        return
    assert port_protocol.encode_error(pcls("boom")) == jax_protocol.encode_error(jcls("boom"))
    # and the port re-raises the kind as its own class
    err = json.loads(jax_protocol.encode_error(jcls("boom")))["error"]
    with pytest.raises(pcls):
        port_protocol.raise_from_error(err)


def test_error_registries_name_the_same_kinds():
    import repro.net.data  # noqa: F401 — registers the codec errors
    import repro_torch.net.data  # noqa: F401

    assert set(port_protocol.ERROR_TYPES) == set(jax_protocol.ERROR_TYPES)
    for name, cls in port_protocol.ERROR_TYPES.items():
        if name not in ("ValueError", "TypeError", "KeyError"):
            assert cls.__module__.startswith("repro_torch."), name


def _malformed():
    whole = jax_protocol.encode_request(
        "publish", ("m", "pub", 0, 0, {"not": "a manifest"}), {"op_id": 0}
    )
    rng = np.random.default_rng(0)
    frames = {f"garbage {i}": rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
              for i, n in enumerate(rng.integers(0, 200, size=12))}
    frames.update({f"truncated at {c}": whole[:c] for c in range(0, len(whole), 7)})
    for v in (0, 2, 7, -1, 999, None, "1"):
        frames[f"version {v!r}"] = json.dumps({"v": v, "op": "latest", "args": ["m"], "kw": {}}).encode()
    frames["unknown field"] = json.dumps({"v": 1, "op": "latest", "args": ["m"], "kw": {}, "extra": 1}).encode()
    frames["a list"] = json.dumps(["not", "a", "dict"]).encode()
    frames["empty op"] = json.dumps({"v": 1, "op": "", "args": [], "kw": {}}).encode()
    frames["args a string"] = json.dumps({"v": 1, "op": "latest", "args": "m", "kw": {}}).encode()
    frames["kw a list"] = json.dumps({"v": 1, "op": "latest", "args": [], "kw": []}).encode()
    frames["op a number"] = json.dumps({"v": 1, "op": 7, "args": [], "kw": {}}).encode()
    frames["undecodable argument"] = json.dumps(
        {"v": 1, "op": "latest", "args": [{"__dc__": "NoSuchClass", "fields": {}}], "kw": {}}
    ).encode()
    frames["non-utf8"] = b"\xff\xfe\x00"
    for op in ("_record", "attach_log", "__init__", "nonexistent", "svc.nope"):
        frames[f"op {op}"] = jax_protocol.encode_request(op, (), {})
    return frames


@pytest.mark.parametrize("label", sorted(_malformed()))
def test_malformed_frames_refused_the_same_way(label):
    data = _malformed()[label]
    jax_svc, port_svc = JaxService(JaxServer()), PortService(PortServer())
    want = jax_svc.handle_frame(data)
    got = port_svc.handle_frame(data)
    assert got == want
    assert json.loads(got)["error"]["kind"] == "ProtocolError"
    with pytest.raises(port_protocol.ProtocolError):
        port_protocol.decode_response(got)
    assert port_svc.server.seq == 0  # refused before any dispatch


@pytest.mark.parametrize("seed", range(4))
def test_garbage_responses_raise_protocol_error(seed):
    data = np.random.default_rng(seed).integers(0, 256, size=64, dtype=np.uint8).tobytes()
    with pytest.raises(port_protocol.ProtocolError):
        port_protocol.decode_response(data)


def test_service_ops_and_directory():
    pair = Pair()
    pair.call("svc.announce", "w0", "pub", 0, "127.0.0.1:1234")
    assert pair.call("svc.peer", "pub", 0) == "127.0.0.1:1234"
    assert pair.call("svc.peers") == {("pub", 0): "127.0.0.1:1234"}
    pair.call("svc.retract", "pub", 0)
    assert pair.call("svc.peer", "pub", 0) is None
    assert pair.port.call("svc.digest") == pair.jax.call("svc.digest")
    pair.port.server.crash()
    pair.jax.server.crash()
    assert pair.port.call("svc.ping")["crashed"] is True
    assert pair.port.handle_frame(jax_protocol.encode_request("latest", ("m",), {})) == \
        pair.jax.handle_frame(jax_protocol.encode_request("latest", ("m",), {}))


def test_remote_client_proxies_the_ports_control_ops():
    shadowed = set(dir(RemoteClient)) & CONTROL_OPS
    assert shadowed <= {"close"}
    client = RemoteClient("127.0.0.1:9")
    assert all(callable(getattr(client, op)) for op in CONTROL_OPS if op != "close")
    with pytest.raises(AttributeError):
        client.attach_log  # noqa: B018 — not a remotable op


def _run_until_crash(server):
    for op, args, kw in recorded_trace():
        if op == "crash":
            break
        try:
            getattr(server, op)(*(_port_value(a) for a in args), **{k: _port_value(v) for k, v in kw.items()})
        except port_errors.TensorHubError:
            pass


def test_recover_path_rebuilds_the_service_server(tmp_path):
    wal = str(tmp_path / "controller.wal")
    svc = PortService(PortServer(heartbeat_timeout=10.0, log=PortOpLog.open_path(wal)))
    _run_until_crash(svc.server)
    svc.server.log.close()
    recovered = port_failover.recover_path(wal)
    assert port_failover.state_digest(recovered) == port_failover.state_digest(svc.server)
    assert recovered.log.path == wal
    # the JAX package recovers the port's WAL file to the same digest
    assert jax_failover.state_digest(jax_failover.recover_path(wal)) == port_failover.state_digest(svc.server)


def test_restart_twice_keeps_appending(tmp_path):
    wal = str(tmp_path / "controller.wal")
    first = PortServer(log=PortOpLog.open_path(wal))
    _run_until_crash(first)
    first.log.close()
    second = port_failover.recover_path(wal)
    second.heartbeat("m", "pub", 0, 200.0)
    second.tick(201.0)
    digest = port_failover.state_digest(second)
    second.log.close()
    third = port_failover.recover_path(wal)
    assert port_failover.state_digest(third) == digest
    third.log.close()


def test_rpc_stats_equal():
    calls = [("latest", 1e-4, True), ("publish", 2.5e-3, True), ("latest", 3e-4, False),
             ("malformed", 1e-6, False), ("publish", 1e-3, True)]
    j, p = JaxRpcStats(), PortRpcStats()
    for op, s, ok in calls:
        j.record(op, s, ok=ok)
        p.record(op, s, ok=ok)
    assert p.snapshot() == j.snapshot()
    assert p.text() == j.text()
    assert 'tensorhub_rpc_calls_total{op="latest"} 2' in p.text()


def _recorded(recorder_cls):
    ticks = iter([0.0, 0.001, 0.002, 0.005, 0.007, 0.0075, 0.009, 0.0125])
    rec = recorder_cls(clock=lambda: next(ticks))
    with rec.span("pull", track="r/s0", source="pub", bytes=1024, codec="int8"):
        rec.span("verify", track="r/s0").end()
    rec.event("done", track="r/s0")
    with rec.span("pull", track="r/s1", source="pub", link_class="vpc_up"):
        pass
    return rec


def test_export_equal(tmp_path):
    j, p = _recorded(JaxRecorder), _recorded(PortRecorder)
    assert port_export.chrome_trace_events(p) == jax_export.chrome_trace_events(j)
    assert port_export.render_timeline(p) == jax_export.render_timeline(j)
    assert port_export.render_timeline(p, tracks=["r/s1"]) == jax_export.render_timeline(j, tracks=["r/s1"])
    jp = jax_export.write_chrome_trace(j, str(tmp_path / "jax.json"))
    pp = port_export.write_chrome_trace(p, str(tmp_path / "port.json"))
    assert open(pp).read() == open(jp).read()
    assert port_export.chrome_trace_events(PortRecorder()) == []
    assert port_export.render_timeline(PortRecorder()) == "(no spans recorded)\n"
