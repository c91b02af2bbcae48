"""A reduced dbrx replica passed between the two packages, on the CPU.

The JAX package's ``NetWorker`` publishes the reduced dbrx (by its
``named_tensors`` names and shapes: the experts' 4-D stacks, the router),
widened to d_model and d_expert 256 so each expert stack (4 MiB in bf16)
is a transfer unit of its own, and the port's ``NetWorker``s replicate
it, and the reverse, through one
networked controller of the other package, in one process over localhost
sockets: r0 pulls raw (dc0), r1 int8 (dc1); the publisher writes v1 in
place and both update (r1 over ``delta:int8`` where the port serves it;
the JAX package's data server refuses every ``delta:int8`` read, see
``tests/test_torch_net_mixed.py``). Every replica's bytes and every v1
manifest (the unit schedule and the checksums) must equal the same
scenario run in process through the JAX package alone, and so must the
wire-byte counts. The experts' stacks are pulled in 1 MiB chunks.

The JAX side's int8 is pinned to its NumPy branch, the byte oracle.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import repro.core as jax_core  # noqa: E402
import repro.net.httpd as jax_httpd  # noqa: E402
import repro.net.service as jax_service  # noqa: E402
import repro.net.worker as jax_worker  # noqa: E402
import repro.transfer.codec as jax_codec  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.lm import DecoderLM as JaxLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
import repro_torch.net.httpd as port_httpd  # noqa: E402
import repro_torch.net.service as port_service  # noqa: E402
import repro_torch.net.worker as port_worker  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import decoder_shapes, from_numpy  # noqa: E402

CHUNK = 1 << 20
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}

JAX = types.SimpleNamespace(
    name="jax", core=jax_core, worker=jax_worker, service=jax_service, httpd=jax_httpd, kw={},
    tensors=lambda w: {k: np.array(a, copy=True) for k, a in w.items()},
    assign=lambda dst, src: dst.__setitem__(Ellipsis, src),
)
PORT = types.SimpleNamespace(
    name="port", core=port_core, worker=port_worker, service=port_service, httpd=port_httpd,
    kw={"device": "cpu"}, tensors=lambda w: from_numpy(w, "cpu"), assign=lambda dst, src: dst.copy_(src),
)
PACKAGES = {"jax": JAX, "port": PORT}


def _dbrx(get_config_of_a_package):
    cfg = get_config_of_a_package("dbrx-132b").reduced()
    return dataclasses.replace(cfg, d_model=256, moe=dataclasses.replace(cfg.moe, d_expert=256))


@pytest.fixture(autouse=True)
def numpy_int8_backend(monkeypatch):
    monkeypatch.setattr(jax_codec.Int8Codec, "_resolve_jax", lambda self: None)


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).view(np.uint8).tobytes()


def _weights(dtype: str, seed: int = 0):
    """v0 and v1 (1/8 of each tensor's 256-element rows perturbed) of the
    reduced dbrx, by the JAX package's names, in its order."""
    shapes = [(n, tuple(s.shape)) for n, s in named_tensors(JaxLM(_dbrx(jax_get_config)).param_specs()).items()]
    assert shapes == decoder_shapes(_dbrx(get_config))
    rng = np.random.default_rng(seed)
    v0, v1 = {}, {}
    for name, shape in shapes:
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        w1 = w.reshape(-1).copy()
        for r in range(0, -(-w1.size // 256), 8):
            seg = slice(r * 256, min((r + 1) * 256, w1.size))
            w1[seg] += rng.standard_normal(w1[seg].size).astype(np.float32) * 0.01
        v0[name] = w.astype(DTYPES[dtype])
        v1[name] = w1.reshape(shape).astype(DTYPES[dtype])
    return v0, v1


def _scenario(pub_pkg, read_pkg, open_pub, open_read, v0, v1, delta):
    trainer = open_pub("dbrx", "trainer", 1, 0, datacenter="dc0")
    trainer.register(pub_pkg.tensors(v0))
    trainer.publish(0)
    zeros = {k: np.zeros_like(v) for k, v in v0.items()}
    r0 = open_read(0)("dbrx", "r0", 1, 0, datacenter="dc0")
    r1 = open_read(1)("dbrx", "r1", 1, 0, datacenter="dc1")
    r0.register(read_pkg.tensors(zeros))
    r1.register(read_pkg.tensors(zeros))
    assert r0.replicate(0, timeout=60) == 0
    assert r1.replicate(0, timeout=60) == 0
    v0_bytes = {n: _bytes(t) for n, t in r0.store.tensors().items()}
    trainer.unpublish()
    for name, arr in pub_pkg.tensors(v1).items():
        pub_pkg.assign(trainer.store.get(name), arr)
    trainer.publish(1)
    if delta:
        assert r1.update("latest")
    assert r0.update("latest")
    return {"trainer": trainer, "r0": r0, "r1": r1}, v0_bytes


def _final(server, handles):
    return {
        key: ({n: _bytes(t) for n, t in h.store.tensors().items()},
              dataclasses.astuple(server.replica_manifest("dbrx", h.current_version, h.replica, h.shard_idx)))
        for key, h in handles.items()
    }


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pub_name", ["jax", "port"])
def test_dbrx_replica_crosses_the_packages_bit_equal(pub_name, dtype):
    pub_pkg = PACKAGES[pub_name]
    read_pkg = PORT if pub_pkg is JAX else JAX
    ctrl_pkg = read_pkg  # the controller of the other package than the publisher's
    v0, v1 = _weights(dtype)
    delta = pub_pkg is PORT

    server = jax_core.ReferenceServer()
    hub = jax_core.TensorHubClient(server, chunk_bytes=CHUNK)
    hs, want_v0 = _scenario(JAX, JAX, hub.open, lambda i: hub.open, v0, v1, delta)
    want, want_wire = _final(server, hs), dict(hub.transport.wire_bytes)

    ctrl_server = ctrl_pkg.core.ReferenceServer()
    http = ctrl_pkg.httpd.ControlServer(ctrl_pkg.service.ReferenceService(ctrl_server)).start()
    workers = [pkg.worker.NetWorker(wid, address=http.address, chunk_bytes=CHUNK, rpc_timeout=20.0, **pkg.kw)
               for pkg, wid in ((pub_pkg, "pub"), (read_pkg, "reader0"), (read_pkg, "reader1"))]
    try:
        hs, got_v0 = _scenario(pub_pkg, read_pkg, workers[0].open, lambda i: workers[1 + i].open, v0, v1, delta)
        got = _final(ctrl_server, hs)
        wire = {}
        for w in workers[1:]:
            for k, v in w.transport.wire_bytes.items():
                wire[k] = wire.get(k, 0) + v
            assert w.transport.conn_opens >= 1  # every read crossed a socket
    finally:
        for w in workers:
            w.close()
        http.shutdown()
    assert got_v0 == want_v0 == {n: _bytes(a) for n, a in v0.items()}  # the raw v0 pull, bit-equal
    assert got.keys() == want.keys()
    for key in want:
        assert got[key][0] == want[key][0], key  # every tensor's bytes (r1: the int8 round trip)
        assert got[key][1] == want[key][1], key  # the v1 manifest: units and checksums
    assert got["r0"][0] == {n: _bytes(a) for n, a in v1.items()}
    assert wire == want_wire
    own = {u[1] for u in got["trainer"][1][1]}
    assert {"layers/ffn/w_gate", "layers/ffn/w_up", "layers/ffn/w_down"} <= own  # units of their own


def test_a_hub_without_delta_bases_updates_over_full_frames():
    """``TensorHubClient(delta_base=False)``: no handle keeps a snapshot of
    its retiring version (the trainer at unpublish, the replicas at
    update), so the int8 replica's ``delta:int8`` update ships base-codec
    (full int8) frames and ends with the bytes of a fresh int8 replicate of
    v1, and the raw replica ends bit-equal to v1."""
    v0, v1 = _weights("bfloat16")
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), chunk_bytes=CHUNK, device="cpu", delta_base=False)
    hs, _ = _scenario(PORT, PORT, hub.open, lambda i: hub.open, v0, v1, delta=True)
    assert all(h.store.base_version is None for h in hs.values())
    assert {n: _bytes(t) for n, t in hs["r0"].store.tensors().items()} == {n: _bytes(a) for n, a in v1.items()}
    fresh = hub.open("dbrx", "r2", 1, 0, datacenter="dc1")
    fresh.register(PORT.tensors({k: np.zeros_like(v) for k, v in v1.items()}))
    assert fresh.replicate("latest", timeout=60) == 1
    assert {n: _bytes(t) for n, t in hs["r1"].store.tensors().items()} == {
        n: _bytes(t) for n, t in fresh.store.tensors().items()}
