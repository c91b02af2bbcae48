"""The wire dtypes the port shares with the JAX package beyond the float
and int types of a model's weights: uint16, uint32, uint64, float8_e4m3fn,
float8_e5m2 and complex64. Each is registered, published, replicated
(raw within a datacenter, int8 across: a passthrough frame, as none of
them is quantizable) and updated (delta:int8, a passthrough again)
through both packages (``device="cpu"`` on the port); the replicas, the
manifests and their checksums must be bit-equal between the two. Then
one TP-4 -> TP-2 resharded pull of a float8_e4m3fn tensor, raw and int8,
through both packages."""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import repro.core as jax_core  # noqa: E402
import repro.transfer.codec as jax_codec  # noqa: E402
from repro.resharding import tp_shard as jax_tp_shard  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
import repro_torch.resharding as port_resharding  # noqa: E402
from repro_torch.core.meta import dtype_from_str, dtype_itemsize, dtype_name  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402

DTYPES = ["uint16", "uint32", "uint64", "float8_e4m3fn", "float8_e5m2", "complex64"]
N = 1024  # elements of the probe tensor


@pytest.fixture(autouse=True)
def numpy_int8_backend(monkeypatch):
    monkeypatch.setattr(jax_codec.Int8Codec, "_resolve_jax", lambda self: None)


def _np_dtype(name):
    return np.dtype(getattr(ml_dtypes, name)) if name.startswith("float8") else np.dtype(name)


def _random(name, shape, seed):
    """Random bits of ``name``'s width: every pattern, NaNs included, must
    cross bit for bit."""
    dt = _np_dtype(name)
    raw = np.random.default_rng(seed).integers(0, 256, int(np.prod(shape)) * dt.itemsize, dtype=np.uint8)
    return raw.view(dt).reshape(shape)


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).view(np.uint8).tobytes()


def _run(core, v0, v1, copy, assign, **hub_kw):
    """trainer (dc0) publishes v0; rollout-0 (dc0) and rollout-1 (dc1)
    replicate; the trainer writes v1 in place and publishes; both update."""
    server = core.ReferenceServer()
    hub = core.TensorHubClient(server, **hub_kw)
    trainer = hub.open("m", "trainer", 1, 0, datacenter="dc0")
    trainer.register(copy(v0))
    trainer.publish(0)
    rollouts = [hub.open("m", f"rollout-{i}", 1, 0, datacenter=f"dc{i}") for i in range(2)]
    for r in rollouts:
        r.register(copy({k: np.zeros_like(a) for k, a in v0.items()}))
        assert r.replicate(0, timeout=60) == 0
    replicated = [{n: _bytes(t) for n, t in r.store.tensors().items()} for r in rollouts]
    trainer.unpublish()
    for name, a in copy(v1).items():
        assign(trainer.store.get(name), a)
    trainer.publish(1)
    for r in rollouts:
        assert r.update("latest")
    return dict(
        replicated=replicated,
        updated=[{n: _bytes(t) for n, t in r.store.tensors().items()} for r in rollouts],
        manifests={rep: server.replica_manifest("m", 1, rep, 0) for rep in ("trainer", "rollout-0", "rollout-1")},
        wire=dict(hub.transport.wire_bytes),
        stats=dict(server.stats),
    )


@pytest.mark.parametrize("name", DTYPES)
def test_dtype_replicates_bit_equal_to_jax(name):
    dt = dtype_from_str(name)
    assert dtype_name(dt) == name and dtype_itemsize(name) == _np_dtype(name).itemsize == dt.itemsize
    v0 = {"w": _random(name, (N,), 0), "m": _random(name, (8, 96), 1)}
    v1 = {k: _random(name, a.shape, 2 + i) for i, (k, a) in enumerate(v0.items())}
    j = _run(jax_core, v0, v1, lambda w: {k: a.copy() for k, a in w.items()}, lambda d, s: d.__setitem__(Ellipsis, s))
    p = _run(port_core, v0, v1, lambda w: from_numpy(w, "cpu"), lambda d, s: d.copy_(s), device="cpu")
    for step, want in (("replicated", v0), ("updated", v1)):
        for i in range(2):
            assert p[step][i] == j[step][i], (step, i)
            assert p[step][i] == {k: _bytes(a) for k, a in want.items()}, (step, i)
    for rep, m in j["manifests"].items():
        assert dataclasses.astuple(p["manifests"][rep]) == dataclasses.astuple(m), rep
        assert {t.dtype for t in m.tensors} == {name}
    assert p["wire"] == j["wire"] and p["stats"] == j["stats"]


def _run_group(handles, fn):
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
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts), "a shard thread hung"
    if errs:
        raise errs[0]


def _resharded(core, tp_shard, glob, copy, zeros_like, **hub_kw):
    """A TP-4 trainer (dc0) publishes; roll-int8 (TP-2, dc1) and then
    roll-raw (TP-2, dc0) replicate it resharded (columns split four ways,
    pulled two ways)."""
    server = core.ReferenceServer()
    hub = core.TensorHubClient(server, chunk_bytes=1 << 12, **hub_kw)
    over = {"w": 1}

    def group(name, tp, dc, fill):
        hs = [hub.open("m", name, tp, i, datacenter=dc) for i in range(tp)]
        for h in hs:
            local, lay = tp_shard(glob, h.shard_idx, tp, axis_overrides=over)
            h.register({n: fill(a) for n, a in local.items()}, layout=lay)
        return hs

    trainer = group("trainer", 4, "dc0", copy)
    _run_group(trainer, lambda h: h.publish(0))
    out = {}
    for name, dc in (("roll-int8", "dc1"), ("roll-raw", "dc0")):
        hs = group(name, 2, dc, zeros_like)
        _run_group(hs, lambda h: h.replicate(0, timeout=60))
        assert all(h.intervals_pulled > 0 for h in hs)  # resharded, not a same-layout copy
        out[name] = [_bytes(h.store.get("w")) for h in hs]
    return out, dict(hub.transport.wire_bytes)


def test_float8_resharded_pull_bit_equal_to_jax():
    glob = {"w": _random("float8_e4m3fn", (64, 256), 7)}
    j = _resharded(jax_core, jax_tp_shard, glob, np.copy, np.zeros_like)
    p = _resharded(port_core, port_resharding.tp_shard, from_numpy(glob, "cpu"), torch.clone, torch.zeros_like,
                   device="cpu")
    assert p == j
    for group, shards in p[0].items():
        for i, b in enumerate(shards):
            assert b == np.ascontiguousarray(glob["w"][:, 128 * i : 128 * (i + 1)]).view(np.uint8).tobytes(), group
