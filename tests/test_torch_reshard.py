"""Cross-layout resharding in the port against the JAX package, on the
same inputs made with numpy from a seed: the planner's intervals, the
plain repack, the plain fused int8 decode, and the whole TP-4 -> TP-2
scenario (raw in dc0, int8 in dc1, replicate then update) through both
packages' clients. Tolerance: bit-equal everywhere.

The JAX side runs its Pallas kernels as its own tests do
(``interpret=True``) and its int8 codec on the NumPy branch, the
bit-exact reference. The port runs on the CPU, where its kernel wrappers
take their plain versions (and launch nothing)."""

import dataclasses
import threading

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import repro.core as jax_core  # noqa: E402
import repro.transfer.codec as jax_codec  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.kernels.quant.fused import fused_repack as jax_fused_repack  # noqa: E402
from repro.kernels.quant.fused import fused_repack_np  # noqa: E402
from repro.kernels.repack import random_instructions, repack_bytes  # noqa: E402
from repro.models.lm import DecoderLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.resharding import layout_from_manifests as jax_layout_from_manifests  # noqa: E402
from repro.resharding import plan_shard as jax_plan_shard  # noqa: E402
from repro.resharding import tp_shard as jax_tp_shard  # noqa: E402
from repro.resharding.executor import repack_np  # noqa: E402
from repro.transfer.engine import WorkerStore as JaxStore  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
import repro_torch.resharding as port_resharding  # noqa: E402
import repro_torch.transfer.codec as port_codec  # noqa: E402
from repro_torch.kernels import repack as port_repack  # noqa: E402
from repro_torch.kernels.quant import fused as port_fused  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.resharding.executor import repack_plain  # noqa: E402
from repro_torch.transfer.engine import WorkerStore as PortStore  # noqa: E402

NP = {
    "float32": np.float32,
    "bfloat16": ml_dtypes.bfloat16,
    "float16": np.float16,
    "float64": np.float64,
}


@pytest.fixture(autouse=True)
def numpy_int8_backend(monkeypatch):
    monkeypatch.setattr(jax_codec.Int8Codec, "_resolve_jax", lambda self: None)


def _fields(x):
    """A dataclass as plain tuples: the two packages' classes differ."""
    return dataclasses.astuple(x)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def _overrides(glob, tp, other_axis):
    """Shard each tensor on its LAST dim divisible by ``tp`` (the default
    rule takes the first): the same TP degree on another axis."""
    if not other_axis:
        return None
    out = {}
    for name, arr in glob.items():
        axes = [a for a, d in enumerate(arr.shape) if d % tp == 0 and d >= tp]
        out[name] = axes[-1] if axes else None
    return out


def _layouts(glob_np, tp, other_axis=False):
    """(JAX layout, port layout, JAX manifests, port manifests) of a TP
    group built by each package's ``tp_shard`` and ``WorkerStore``."""
    over = _overrides(glob_np, tp, other_axis)
    glob_t = from_numpy(glob_np, "cpu")
    jm, pm = {}, {}
    for i in range(tp):
        jl, jlay = jax_tp_shard(glob_np, i, tp, axis_overrides=over)
        pl, play = port_resharding.tp_shard(glob_t, i, tp, axis_overrides=over)
        assert jlay == play
        for n in jl:
            assert np.ascontiguousarray(jl[n]).view(np.uint8).tobytes() == _bytes(pl[n])
        js, ps = JaxStore(f"j{i}"), PortStore(f"p{i}", device="cpu")
        js.register(jl, layout=jlay)
        ps.register(pl, layout=play)
        jm[i] = js.build_manifest(with_checksums=False)
        pm[i] = ps.build_manifest(with_checksums=False)
        assert _fields(pm[i]) == _fields(jm[i])
    return (
        jax_layout_from_manifests(jm, tp),
        port_resharding.layout_from_manifests(pm, tp),
        jm,
        pm,
    )


def _assert_same_plans(glob_np, src_tp, dst_tp, codec, *, other_axis=False, stripe_min=1 << 20):
    js, ps, _, _ = _layouts(glob_np, src_tp)
    jd, pd, jdm, _ = _layouts(glob_np, dst_tp, other_axis)
    assert _fields(ps) == _fields(js)
    assert _fields(pd) == _fields(jd)
    n_intervals = 0
    for shard in range(dst_tp):
        kw = dict(num_dest_units=jdm[shard].num_units, codec=codec, stripe_min=stripe_min)
        jp = jax_plan_shard(js, jd, shard, **kw)
        pp = port_resharding.plan_shard(ps, pd, shard, **kw)
        assert _fields(pp) == _fields(jp), (src_tp, dst_tp, shard, codec)
        n_intervals += len(pp.intervals)
    return n_intervals


def _model(seed=0, dtype="bfloat16"):
    """Mixed ranks: stacked layer tensors whose first dim no TP divides
    (so TP-4 and TP-2 cut different axes), a 2-D tensor both cut on
    dim 0, and a replicated odd bias."""
    rng = np.random.default_rng(seed)
    shapes = {"layers/w": (6, 64, 96), "layers/ln": (6, 64), "embed": (96, 32), "bias": (5,)}
    return {n: rng.standard_normal(s).astype(NP[dtype]) for n, s in shapes.items()}


@pytest.mark.parametrize("codec", ["raw", "int8"])
@pytest.mark.parametrize(
    "src_tp,dst_tp,other_axis", [(4, 2, False), (2, 4, False), (2, 3, False), (4, 4, True)]
)
def test_plans_equal_jax(src_tp, dst_tp, other_axis, codec):
    assert _assert_same_plans(_model(), src_tp, dst_tp, codec, other_axis=other_axis) > 0


_DIMS = [1, 2, 3, 4, 5, 6, 8, 12, 64, 96, 256]


@settings(max_examples=30, deadline=None)
@given(
    pair=st.sampled_from([(4, 2, False), (2, 4, False), (2, 3, False), (4, 4, True)]),
    codec=st.sampled_from(["raw", "int8"]),
    dtype=st.sampled_from(["float32", "bfloat16"]),
    shapes=st.lists(st.lists(st.sampled_from(_DIMS), min_size=1, max_size=3), min_size=1, max_size=4),
    stripe_min=st.sampled_from([16, 1 << 20]),
    seed=st.integers(0, 1000),
)
def test_plans_equal_jax_sweep(pair, codec, dtype, shapes, stripe_min, seed):
    rng = np.random.default_rng(seed)
    glob = {f"t{i}": rng.standard_normal(tuple(s)).astype(NP[dtype]) for i, s in enumerate(shapes)}
    src_tp, dst_tp, other_axis = pair
    _assert_same_plans(glob, src_tp, dst_tp, codec, other_axis=other_axis, stripe_min=stripe_min)


def test_unconvertible_layouts_raise_in_both():
    glob = _model()
    js, ps, _, _ = _layouts({k: v for k, v in glob.items() if k != "bias"}, 2)
    jd, pd, _, _ = _layouts(glob, 4)
    with pytest.raises(jax_core.ShardLayoutError):
        jax_plan_shard(js, jd, 0)
    with pytest.raises(port_core.ShardLayoutError):
        port_resharding.plan_shard(ps, pd, 0)


# ---------------------------------------------------------------------------
# repack (kernel 3's plain version)
# ---------------------------------------------------------------------------


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).view(np.uint8).tobytes()


@pytest.mark.parametrize("gaps", [False, True])
@pytest.mark.parametrize("seed", range(5))
def test_repack_plain_equals_jax(seed, gaps):
    rng = np.random.default_rng(seed)
    out_nbytes = int(rng.integers(1, 6000))
    full = random_instructions(rng, out_nbytes)
    staging = rng.integers(0, 256, sum(n for _, _, n in full) + 7, dtype=np.uint8)
    runs = full[::2] if gaps else full  # a dropped run's bytes must read 0
    want = repack_np(staging, runs, out_nbytes)
    assert np.array_equal(np.asarray(repack_bytes(staging, runs, out_nbytes, interpret=True)), want)
    st_t = torch.from_numpy(staging.copy())
    before = port_repack.LAUNCHES.value
    assert _bytes(repack_plain(st_t, runs, out_nbytes)) == want.tobytes()
    assert _bytes(port_repack.gather_bytes(st_t, runs, out_nbytes)) == want.tobytes()
    assert port_repack.LAUNCHES.value == before  # the CPU takes the plain version
    assert port_repack.covers([(d, n) for _, d, n in runs], out_nbytes) == (len(runs) == len(full))


def test_repack_rejects_out_of_range_runs():
    st_t = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError):
        port_repack.gather_bytes(st_t, [(0, 10, 8)], 16)
    with pytest.raises(ValueError):
        port_repack.gather_bytes(st_t, [(12, 0, 8)], 16)


def test_covers():
    assert port_repack.covers([(0, 4), (4, 4)], 8)
    assert port_repack.covers([(4, 4), (0, 5)], 8)
    assert not port_repack.covers([(0, 4), (5, 3)], 8)
    assert not port_repack.covers([(0, 4)], 8)
    assert port_repack.covers([], 0)


# ---------------------------------------------------------------------------
# fused dequant + gather (kernel 4's plain version)
# ---------------------------------------------------------------------------


def _wire(dtype, n, seed, poison=False):
    x = (np.random.default_rng(seed).standard_normal(n) * 2).astype(NP[dtype])
    if poison:
        x[n // 2] = np.inf  # a non-finite payload ships as a passthrough frame
    return jax_codec.Int8Codec(backend="numpy").encode(x.view(np.uint8).reshape(-1), dtype)


def _frames(wires):
    """Each wire parsed by both packages: (JAX frames, port frames)."""
    jf = [jax_codec.parse_int8_frame(w) for w in wires]
    pf = [port_codec.parse_int8_frame(torch.from_numpy(w.copy())) for w in wires]
    return jf, pf


def _layout_placements(wires_spec):
    """Placements (frame index, lead, nbytes, unit offset), one per
    ``(lead, nbytes, gap)``, packed into one unit with ``gap`` bytes
    before each and 24 uncovered bytes at the end; returns (placements,
    unit bytes)."""
    pos, out = 0, []
    for k, (lead, nbytes, gap) in enumerate(wires_spec):
        pos += gap
        out.append((k, lead, nbytes, pos))
        pos += nbytes
    return out, pos + 24


def _check_fused(wires, specs, out_nbytes, *, interpret):
    jf, pf = _frames(wires)
    jp = [(jf[k], lead, nb, uo) for k, lead, nb, uo in specs]
    pp = [(pf[k], lead, nb, uo) for k, lead, nb, uo in specs]
    want = fused_repack_np(jp, out_nbytes)
    if interpret:
        assert np.array_equal(np.asarray(jax_fused_repack(jp, out_nbytes, interpret=True)), want)
    before = port_fused.LAUNCHES.value
    assert _bytes(port_fused.fused_repack_plain(pp, out_nbytes)) == want.tobytes()
    assert _bytes(port_fused.fused_repack(pp, out_nbytes)) == want.tobytes()
    assert port_fused.LAUNCHES.value == before
    return want


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_fused_plain_equals_jax(dtype):
    isz = np.dtype(NP[dtype]).itemsize
    rb = 256 * isz
    wires = [
        _wire(dtype, 1000, 1),  # ragged: 3 rows + 232 elements
        _wire(dtype, 512, 2),
        _wire(dtype, 300, 3, poison=True),  # passthrough
        _wire(dtype, 777, 4),
    ]
    specs, out_nbytes = _layout_placements([
        (rb, (1000 - 256 - 100) * isz, 0),  # lead-trimmed one row, tail into the ragged row
        (0, 512 * isz, 0),  # a whole frame
        (4 * isz, 200 * isz, 2 * isz),  # passthrough overlay after a gap
        (3 * isz, 700 * isz, 0),  # lead inside a row, ragged last row
    ])
    want = _check_fused(wires, specs, out_nbytes, interpret=True)
    assert not want[-24:].any()  # the uncovered tail reads 0


def test_fused_plain_f64_and_mixed_equal_jax():
    wires = [
        _wire("float64", 600, 5),
        _wire("bfloat16", 513, 6),
        _wire("float32", 256, 7),
        _wire("float16", 300, 8, poison=True),
        _wire("float16", 900, 9),
    ]
    specs, out_nbytes = _layout_placements([
        (8 * 7, 8 * 500, 0),
        (3, 2 * 400 + 1, 1),  # byte-misaligned lead, odd length and output offset
        (0, 4 * 256, 3),
        (1, 97, 0),  # passthrough
        (2 * 256, 2 * 644, 0),  # to the frame's end
    ])
    _check_fused(wires, specs, out_nbytes, interpret=False)


def test_fused_rejects_out_of_range_placements():
    _, pf = _frames([_wire("float32", 256, 0)])
    with pytest.raises(ValueError):
        port_fused.fused_repack([(pf[0], 4, 1024, 0)], 2048)
    with pytest.raises(ValueError):
        port_fused.fused_repack([(pf[0], 0, 1024, 1500)], 2048)


def test_executor_dispatches_on_its_device():
    """The executor's staging lives on its device and the repack follows
    the device, whatever ``use_kernel`` says (kept for API parity)."""
    glob = _model(dtype="float32")
    _, ps, _, _ = _layouts(glob, 4)
    _, pd, _, pdm = _layouts(glob, 2)
    plan = port_resharding.plan_shard(ps, pd, 0, num_dest_units=pdm[0].num_units)
    ex = port_resharding.ReshardExecutor(plan, pdm[0], use_kernel=True)
    assert ex.device == torch.device("cpu")
    unit, placed = next(ex.unit_batches())
    staging = ex.make_staging(unit.index)
    assert staging.device == torch.device("cpu") and staging.numel() == ex.staging_bytes(unit.index)
    staging.copy_(torch.arange(staging.numel()).to(torch.uint8))
    before = port_repack.LAUNCHES.value
    got = ex.repack(unit.index, staging)
    assert torch.equal(got, repack_plain(staging, ex.instructions(unit.index), unit.nbytes))
    assert port_repack.LAUNCHES.value == before


# ---------------------------------------------------------------------------
# the slice as a whole: TP-4 -> TP-2, raw (dc0) and int8 (dc1), then v1
# ---------------------------------------------------------------------------

#: llama3-8b cut to two layers and narrow widths (as in test_torch_transfer):
#: at TP-4 the stacked [2, 256, X] layer tensors shard on dim 1 (4 does not
#: divide 2), at TP-2 on dim 0, so every layer tensor is a cross-axis
#: reshard; embed and head shard on dim 0 at both
SMALL = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=4096, vocab=8192)


def _llama_weights():
    """v0 and v1 (1/8 of each tensor's 256-element rows perturbed), bf16,
    global (unsharded) tensors."""
    cfg = dataclasses.replace(get_config("llama3-8b"), **SMALL)
    shapes = [(n, tuple(s.shape)) for n, s in named_tensors(DecoderLM(cfg).param_specs()).items()]
    rng = np.random.default_rng(0)
    v0, v1 = {}, {}
    for name, shape in shapes:
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        flat = w.reshape(-1).copy()
        for r in range(0, -(-flat.size // 256), 8):
            seg = slice(r * 256, min((r + 1) * 256, flat.size))
            flat[seg] += rng.standard_normal(flat[seg].size).astype(np.float32) * 0.01
        v0[name] = w.astype(ml_dtypes.bfloat16)
        v1[name] = flat.reshape(shape).astype(ml_dtypes.bfloat16)
    return v0, v1


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


def _scenario(core, tp_shard, glob, v1, copy, zeros_like, assign, **hub_kw):
    """trainer TP-4 (dc0) publishes v0; roll-int8 TP-2 (dc1) and then
    roll-raw TP-2 (dc0) replicate it; the trainer unpublishes, writes v1
    into its buffers in place and publishes; both update. roll-int8 goes
    first each time: while only the trainer holds a version, its source
    is the trainer, so it reshards (a finished TP-2 replica would be a
    same-layout source it prefers)."""
    server = core.ReferenceServer()
    hub = core.TensorHubClient(server, chunk_bytes=1 << 20, **hub_kw)

    def group(name, tp, dc, fill):
        hs = [hub.open("m", name, tp, i, datacenter=dc) for i in range(tp)]
        for h in hs:
            local, lay = tp_shard(glob, h.shard_idx, tp)
            # every shard owns its buffers (a shard may be a view of glob)
            h.register({n: fill(a) for n, a in local.items()}, layout=lay)
        return hs

    trainer = group("trainer", 4, "dc0", copy)
    _run_group(trainer, lambda h: h.publish(0))
    roll_i8 = group("roll-int8", 2, "dc1", zeros_like)
    roll_raw = group("roll-raw", 2, "dc0", zeros_like)
    snaps = {}

    def snap(label):
        snaps[label] = dict(
            wire=dict(hub.transport.wire_bytes),
            decoded=dict(hub.transport.decoded_bytes),
            stats=dict(server.stats),
            intervals=[h.intervals_pulled for h in roll_i8 + roll_raw],
            tensors={
                (g, h.shard_idx, n): _bytes(t)
                for g, hs in (("int8", roll_i8), ("raw", roll_raw))
                for h in hs
                for n, t in h.store.tensors().items()
            },
        )

    _run_group(roll_i8, lambda h: h.replicate(0, timeout=60))
    _run_group(roll_raw, lambda h: h.replicate(0, timeout=60))
    snap("v0")
    _run_group(trainer, lambda h: h.unpublish())
    for h in trainer:
        local, _ = tp_shard(v1, h.shard_idx, 4)
        for n, a in local.items():
            assign(h.store.get(n), a)
    _run_group(trainer, lambda h: h.publish(1))
    _run_group(roll_i8, lambda h: h.update("latest"))
    _run_group(roll_raw, lambda h: h.update("latest"))
    snap("v1")
    return snaps


@pytest.fixture(scope="module")
def both_scenarios():
    v0, v1 = _llama_weights()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_codec.Int8Codec, "_resolve_jax", lambda self: None)
    try:
        jax_run = _scenario(
            jax_core, jax_tp_shard, v0, v1, np.copy, np.zeros_like,
            lambda d, s: d.__setitem__(Ellipsis, s),
        )
    finally:
        mp.undo()
    port_run = _scenario(
        port_core, port_resharding.tp_shard, from_numpy(v0, "cpu"), from_numpy(v1, "cpu"),
        torch.clone, torch.zeros_like, lambda d, s: d.copy_(s), device="cpu",
    )
    return jax_run, port_run, v0, v1


@pytest.mark.parametrize("step", ["v0", "v1"])
def test_scenario_tensors_equal_jax(both_scenarios, step):
    j, p, v0, v1 = both_scenarios
    assert p[step]["tensors"].keys() == j[step]["tensors"].keys()
    for key, b in j[step]["tensors"].items():
        assert p[step]["tensors"][key] == b, key
    # the raw group holds the trainer's bytes, the int8 group is close
    want = v0 if step == "v0" else v1
    for (group, shard, name), b in p[step]["tensors"].items():
        local, _ = jax_tp_shard(want, shard, 2)
        ref = np.ascontiguousarray(local[name])
        if group == "raw":
            assert b == ref.view(np.uint8).tobytes(), name
        else:
            got = np.frombuffer(b, ml_dtypes.bfloat16).astype(np.float32)
            w = ref.reshape(-1).astype(np.float32)
            assert np.max(np.abs(got - w)) / max(np.max(np.abs(w)), 1e-12) < 0.01, name


@pytest.mark.parametrize("step", ["v0", "v1"])
def test_scenario_counters_and_stats_equal_jax(both_scenarios, step):
    j, p, _, _ = both_scenarios
    for key in ("wire", "decoded", "stats", "intervals"):
        assert p[step][key] == j[step][key], key
    assert all(n > 0 for n in p[step]["intervals"])  # every rollout resharded
    wire, dec = p[step]["wire"], p[step]["decoded"]
    assert wire["vpc_up"] / dec["vpc_up"] < 0.52  # int8 rode the WAN, not raw
    assert p[step]["stats"]["codec_degrades"] == 0


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device
    launches the kernel or raises (here: a tensor with no storage)."""
    meta = torch.empty(64, dtype=torch.uint8, device="meta")
    with pytest.raises(TypeError, match="unsupported device"):
        port_repack.gather_bytes(meta, [(0, 0, 64)], 64)
    _, pf = _frames([_wire("float32", 256, 0)])
    with pytest.raises(ValueError, match="several devices"):  # CPU frames, another device
        port_fused.fused_repack([(pf[0], 0, 1024, 0)], 1024, device="meta")
    with pytest.raises(TypeError, match="CUDA device"):
        port_fused.dequant_gather([(pf[0], 0, 1024, 0)], 1024, torch.device("cpu"))
