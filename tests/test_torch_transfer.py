"""The slice as a whole: the same publish -> replicate (raw, int8) ->
delta update scenario through the JAX package and through the port
(``device="cpu"``), on the same weights, must agree byte for byte —
manifests, final replica bytes, per-link-class byte counters and server
stats."""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import repro.core as jax_core  # noqa: E402
import repro.transfer.codec as jax_codec  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models.lm import DecoderLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs.llama3_8b import CONFIG as PORT_LLAMA  # noqa: E402
from repro_torch.models.params import decoder_shapes, from_numpy, llama3_8b_shapes  # noqa: E402

#: llama3-8b cut to two layers and narrow widths: embed, head and the
#: three ffn tensors (4 MiB each) are units of their own and split into
#: 1 MiB chunks; attention and norms compact into buckets
SMALL = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=4096, vocab=8192)
CHUNK = 1 << 20


def _jax_shapes(**widths):
    cfg = dataclasses.replace(get_config("llama3-8b"), **widths)
    return [(n, tuple(s.shape)) for n, s in named_tensors(DecoderLM(cfg).param_specs()).items()]


def test_llama3_8b_shapes_match_jax_param_specs():
    assert llama3_8b_shapes() == _jax_shapes()
    assert llama3_8b_shapes(10) == _jax_shapes(num_layers=10)
    assert decoder_shapes(dataclasses.replace(PORT_LLAMA, **SMALL)) == _jax_shapes(**SMALL)


def _weights():
    """v0 and v1 (1/8 of each tensor's 256-element rows perturbed), bf16."""
    rng = np.random.default_rng(0)
    v0, v1 = {}, {}
    for name, shape in _jax_shapes(**SMALL):
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        flat = w.reshape(-1)
        w1 = flat.copy()
        nrows = -(-flat.size // 256)
        for r in range(0, nrows, 8):
            seg = slice(r * 256, min((r + 1) * 256, flat.size))
            w1[seg] += rng.standard_normal(w1[seg].size).astype(np.float32) * 0.01
        v0[name] = w.astype(ml_dtypes.bfloat16)
        v1[name] = w1.reshape(shape).astype(ml_dtypes.bfloat16)
    return v0, v1


def _run(core, weights, v1, make, assign):
    """trainer (dc0) publishes v0; rollout-0 (dc0) and rollout-1 (dc1)
    replicate; the trainer unpublishes, writes v1 into its registered
    buffers in place and publishes; both rollouts update."""
    server = core.ReferenceServer()
    hub = core.TensorHubClient(server, chunk_bytes=CHUNK, **(
        {"device": "cpu"} if core is port_core else {}
    ))
    trainer = hub.open("m", "trainer", 1, 0, datacenter="dc0")
    trainer.register(make(weights))
    trainer.publish(0)
    r0 = hub.open("m", "rollout-0", 1, 0, datacenter="dc0")
    r1 = hub.open("m", "rollout-1", 1, 0, datacenter="dc1")
    zeros = {k: np.zeros_like(v) for k, v in weights.items()}
    r0.register(make(zeros))
    r1.register(make(zeros))
    assert r0.replicate(0, timeout=60) == 0
    assert r1.replicate(0, timeout=60) == 0
    after_replicate = (dict(hub.transport.wire_bytes), dict(hub.transport.decoded_bytes))
    trainer.unpublish()
    for name, arr in make(v1).items():
        assign(trainer.store.get(name), arr)
    trainer.publish(1)
    assert r0.update("latest") and r1.update("latest")
    manifests = {
        (rep, v): server.replica_manifest("m", v, rep, 0)
        for rep, v in [("trainer", 1), ("rollout-0", 1), ("rollout-1", 1)]
    }
    return dict(
        server=server,
        hub=hub,
        manifest_trainer=trainer.store.build_manifest(),
        manifests=manifests,
        replicas={name: h.store.tensors() for name, h in (("r0", r0), ("r1", r1), ("t", trainer))},
        after_replicate=after_replicate,
    )


def _np_assign(dst, src):
    dst[...] = src


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).view(np.uint8).tobytes()


@pytest.fixture(scope="module")
def both_runs():
    v0, v1 = _weights()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_codec.Int8Codec, "_resolve_jax", lambda self: None)
    try:
        jax_run = _run(jax_core, v0, v1, lambda w: {k: a.copy() for k, a in w.items()}, _np_assign)
    finally:
        mp.undo()
    port_run = _run(port_core, v0, v1, lambda w: from_numpy(w, "cpu"), lambda d, s: d.copy_(s))
    return jax_run, port_run, v1


def _fields(manifest):
    """A manifest as plain tuples: the two packages' dataclasses are
    distinct classes, so they never compare equal as objects."""
    return dataclasses.astuple(manifest)


def test_manifests_equal(both_runs):
    j, p, _ = both_runs
    assert _fields(p["manifest_trainer"]) == _fields(j["manifest_trainer"])
    assert any(u.nbytes > CHUNK for u in p["manifest_trainer"].units)  # chunked units ran
    assert any(u.is_compact for u in p["manifest_trainer"].units)
    for key, m in j["manifests"].items():
        assert _fields(p["manifests"][key]) == _fields(m), key


def test_final_replica_bytes_equal(both_runs):
    j, p, v1 = both_runs
    for rep in ("t", "r0", "r1"):
        for name, arr in j["replicas"][rep].items():
            assert _bytes(p["replicas"][rep][name]) == _bytes(arr), (rep, name)
    # rollout-0 is raw: bit-identical to the trainer; rollout-1 is lossy
    for name, arr in v1.items():
        assert _bytes(p["replicas"]["r0"][name]) == _bytes(arr)
        got = p["replicas"]["r1"][name].to(torch.float32).numpy()
        want = arr.astype(np.float32)
        assert np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-12) < 0.01


def test_byte_counters_and_stats_equal(both_runs):
    j, p, _ = both_runs
    jt, pt = j["hub"].transport, p["hub"].transport
    assert p["after_replicate"] == j["after_replicate"]
    assert pt.wire_bytes == jt.wire_bytes
    assert pt.decoded_bytes == jt.decoded_bytes
    assert pt.bytes_moved == jt.bytes_moved
    assert pt.delta_stale_fallbacks == jt.delta_stale_fallbacks == 0
    assert p["server"].stats == j["server"].stats
    assert p["server"].stats["delta_assignments"] >= 1
    # the int8 leg ships about half of bf16's bytes; the delta leg far less
    wire, dec = p["after_replicate"]
    assert wire["vpc_up"] / dec["vpc_up"] < 0.52
    delta_wire = pt.wire_bytes["vpc_up"] - wire["vpc_up"]
    delta_dec = pt.decoded_bytes["vpc_up"] - dec["vpc_up"]
    assert delta_wire / delta_dec < 0.2


def test_resharding_not_ported_raises():
    """The resharded pull used to raise "not yet ported"; it now runs: a
    TP-2 replica pulls a TP-1 source bit for bit, and no shard raises."""
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu")
    full = {"w": torch.arange(64 * 64, dtype=torch.float32).view(64, 64)}
    src = hub.open("m", "src", 1, 0)
    src.register(full, layout={"w": ((64, 64), (0, 0))})
    src.publish(0)
    dst = [hub.open("m", "dst", 2, i) for i in range(2)]
    errs = []

    def pull(i):
        try:
            dst[i].register(
                {"w": torch.zeros(32, 64)}, layout={"w": ((64, 64), (32 * i, 0))}
            )
            dst[i].replicate(0, timeout=30)
        except Exception as e:  # noqa: BLE001 — collected for the assertion
            errs.append(e)

    ts = [threading.Thread(target=pull, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs
    for i in range(2):
        assert torch.equal(dst[i].store.get("w"), full["w"][32 * i : 32 * (i + 1)])
        assert dst[i].intervals_pulled > 0
