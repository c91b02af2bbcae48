"""The port's wire codecs against the JAX package's (NumPy int8 backend):
byte-identical ``TWQ8``/``TWD8`` frames, identical decodes, the same
fallbacks and the same integrity failures."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import repro.transfer.codec as jax_codec  # noqa: E402

import repro_torch.transfer.codec as port_codec  # noqa: E402
from repro_torch.kernels.quant import quantize_rows_plain  # noqa: E402

NP = {
    "float32": np.float32,
    "bfloat16": ml_dtypes.bfloat16,
    "float16": np.float16,
    "float64": np.float64,
}


@pytest.fixture(autouse=True)
def numpy_int8_backend(monkeypatch):
    """The JAX package's bit-exact int8 reference is its NumPy branch;
    this also covers the Int8Codec inside its DeltaCodec."""
    monkeypatch.setattr(jax_codec.Int8Codec, "_resolve_jax", lambda self: None)


def _payload(dtype: str, n: int, seed: int, scale: float = 3.0) -> np.ndarray:
    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(NP[dtype])
    return np.ascontiguousarray(x).view(np.uint8).reshape(-1)


def _t(b: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(b, dtype=np.uint8, copy=True))


def _same(t: torch.Tensor, a: np.ndarray) -> bool:
    return t.dtype == torch.uint8 and np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096, 100_001])
def test_int8_frames_byte_identical(dtype, n):
    payload = _payload(dtype, n, seed=n)
    jc, pc = jax_codec.Int8Codec(), port_codec.Int8Codec()
    wj, wp = jc.encode(payload, dtype), pc.encode(_t(payload), dtype)
    assert _same(wp, wj)
    assert wp.numel() == pc.wire_nbytes(payload.nbytes, dtype) == jc.wire_nbytes(payload.nbytes, dtype)
    assert _same(pc.decode(wp), jc.decode(wj))
    assert pc.row_bytes(dtype) == jc.row_bytes(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_int8_plain_quantizer_substitutes_kernel(dtype):
    payload = _payload(dtype, 3000, seed=1)
    a = port_codec.Int8Codec().encode(_t(payload), dtype)
    b = port_codec.Int8Codec(quantize=quantize_rows_plain).encode(_t(payload), dtype)
    assert torch.equal(a, b)


@pytest.mark.parametrize("poison", [np.nan, np.inf, -np.inf])
def test_int8_non_finite_passthrough(poison):
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    x[137] = poison
    payload = x.view(np.uint8)
    wj = jax_codec.Int8Codec().encode(payload, "float32")
    wp = port_codec.Int8Codec().encode(_t(payload), "float32")
    assert _same(wp, wj)
    assert _same(port_codec.Int8Codec().decode(wp), payload)
    big = np.full(300, 1e308, np.float64).view(np.uint8)  # overflows f32
    wp = port_codec.Int8Codec().encode(_t(big), "float64")
    assert _same(wp, jax_codec.Int8Codec().encode(big, "float64"))
    assert _same(port_codec.Int8Codec().decode(wp), big)


@pytest.mark.parametrize(
    "payload,dtype",
    [
        (np.zeros(0, np.uint8), "float32"),
        (np.arange(999, dtype=np.int32).view(np.uint8), "int32"),
        (np.frombuffer(b"hello world!", np.uint8), None),
        (np.arange(7, dtype=np.uint8), "float32"),  # not whole elements
    ],
)
def test_int8_passthrough_cases(payload, dtype):
    wj = jax_codec.Int8Codec().encode(payload, dtype)
    wp = port_codec.Int8Codec().encode(_t(payload), dtype)
    assert _same(wp, wj)
    assert _same(port_codec.Int8Codec().decode(wp), jax_codec.Int8Codec().decode(wj))


def test_int8_integrity_failures():
    pc = port_codec.Int8Codec()
    wire = pc.encode(_t(_payload("float32", 1000, 0)), "float32")
    for bad in (wire[:-3], wire[:4]):
        with pytest.raises(port_codec.CodecError):
            pc.decode(bad)
    magic = wire.clone()
    magic[:4] = 0
    with pytest.raises(port_codec.CodecError):
        pc.decode(magic)
    nan_scale = wire.clone()
    nan_scale[20:24] = torch.from_numpy(np.frombuffer(np.float32(np.nan).tobytes(), np.uint8).copy())
    with pytest.raises(port_codec.CodecError):
        pc.decode(nan_scale)


def _versions(dtype: str, n: int, changed_every: int = 4, seed: int = 21):
    """A base and a correlated next version that differs in every
    ``changed_every``-th 256-element row."""
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(n).astype(np.float32)
    v1 = v0.copy()
    rows = -(-n // 256)
    for r in range(0, rows, changed_every):
        v1[r * 256 : (r + 1) * 256] = v1[r * 256 : (r + 1) * 256] * 1.001 + 0.01
    cast = lambda v: np.ascontiguousarray(v.astype(NP[dtype])).view(np.uint8)  # noqa: E731
    return cast(v0), cast(v1)


@pytest.mark.parametrize("base_name", ["int8", "raw"])
@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("n", [255, 4096, 10_001])
def test_delta_frames_byte_identical(base_name, dtype, n):
    v0, v1 = _versions(dtype, n)
    jd = jax_codec.DeltaCodec(base_name)
    pd = port_codec.DeltaCodec(base_name)
    held = v0 if base_name == "raw" else jax_codec.Int8Codec().decode(
        jax_codec.Int8Codec().encode(v0, dtype)
    )
    wj = jd.encode(v1, dtype, base=v0)
    wp = pd.encode(_t(v1), dtype, base=_t(v0))
    assert _same(wp, wj)
    assert _same(pd.decode(wp, base=_t(held)), jd.decode(wj, base=held))
    assert pd.wire_nbytes_at(v1.nbytes, dtype, 0.25) == jd.wire_nbytes_at(v1.nbytes, dtype, 0.25)


def test_delta_identical_versions_ship_bitmap_only():
    v0, _ = _versions("float32", 4096)
    wj = jax_codec.DeltaCodec("int8").encode(v0, "float32", base=v0)
    wp = port_codec.DeltaCodec("int8").encode(_t(v0), "float32", base=_t(v0))
    assert _same(wp, wj)
    assert wp.numel() == 28 + 2  # header + 16-row bitmap


@pytest.mark.parametrize("base_name", ["int8", "raw"])
def test_delta_fallbacks_byte_identical(base_name):
    v0, v1 = _versions("bfloat16", 3000)
    jd, pd = jax_codec.DeltaCodec(base_name), port_codec.DeltaCodec(base_name)
    # no base, size mismatch, non-finite payload, non-quantizable dtype
    poisoned = v1.copy().view(ml_dtypes.bfloat16)
    poisoned[5] = np.nan
    poisoned = poisoned.view(np.uint8)
    cases = [
        (v1, "bfloat16", None),
        (v1, "bfloat16", v0[:-2]),
        (poisoned, "bfloat16", v0),
        (v1, "int16", v0),
        (np.zeros(0, np.uint8), "bfloat16", np.zeros(0, np.uint8)),
    ]
    for payload, dtype, base in cases:
        wj = jd.encode(payload, dtype, base=base)
        wp = pd.encode(_t(payload), dtype, base=None if base is None else _t(base))
        assert _same(wp, wj), (dtype, None if base is None else base.nbytes)
        assert _same(pd.decode(wp), jd.decode(wj))


def test_delta_stale_base_rejected():
    v0, v1 = _versions("float32", 4096)
    pd = port_codec.DeltaCodec("int8")
    wire = pd.encode(_t(v1), "float32", base=_t(v0))
    with pytest.raises(port_codec.StaleBaseError):
        pd.decode(wire, base=None)
    with pytest.raises(port_codec.StaleBaseError):
        pd.decode(wire, base=_t(v0[:-4]))
    with pytest.raises(port_codec.StaleBaseError):
        pd.decode(wire, base=torch.zeros(v0.nbytes, dtype=torch.uint8))
    torn = wire[: wire.numel() - 5]
    held = port_codec.Int8Codec().decode(port_codec.Int8Codec().encode(_t(v0), "float32"))
    with pytest.raises(port_codec.CodecError) as e:
        pd.decode(torn, base=held)
    assert not isinstance(e.value, port_codec.StaleBaseError)


def test_packbits_msb_first():
    bits = np.random.default_rng(2).integers(0, 2, 37).astype(bool)
    packed = port_codec.packbits(torch.from_numpy(bits))
    assert np.array_equal(packed.numpy(), np.packbits(bits.astype(np.uint8)))
    assert np.array_equal(port_codec.unpackbits(packed, 37).numpy(), bits)


def test_registry_is_the_ports_own():
    c = port_codec.get_codec("delta:int8")
    assert isinstance(c, port_codec.DeltaCodec)
    assert "delta:int8" not in jax_codec._REGISTRY or not isinstance(
        jax_codec._REGISTRY["delta:int8"], port_codec.DeltaCodec
    )
    assert port_codec.reshard_wire_codec("delta:int8") == "int8"
    with pytest.raises(port_codec.TensorHubError):
        port_codec.get_codec("zstd")
