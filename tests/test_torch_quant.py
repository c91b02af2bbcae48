"""The port's int8 row quantizer (plain PyTorch version, as the CPU runs
it) against the JAX package: bit-equal to the NumPy branch of
``Int8Codec._quant_rows``, and within the Pallas kernel's stated
tolerance (q within 1, scales rtol 1e-6: XLA folds the /127 into a
reciprocal multiply, which the NumPy branch does not)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.transfer.codec import Int8Codec  # noqa: E402

from repro_torch.kernels.quant import (  # noqa: E402
    dequantize_rows,
    quantize_rows,
    quantize_rows_plain,
)
from repro_torch.models.params import from_numpy  # noqa: E402

NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16, "float16": np.float16}


def _numpy_ref(x: np.ndarray):
    """The JAX package's bit-exact reference: zero-pad to whole rows of
    256 in f32, then the NumPy branch of ``_quant_rows``."""
    xf = x.astype(np.float32)
    pad = (-xf.size) % 256
    xf = np.concatenate([xf, np.zeros(pad, np.float32)]).reshape(-1, 256)
    q, s = Int8Codec(backend="numpy")._quant_rows(xf)
    return q.reshape(-1), s


def _torch(x: np.ndarray) -> torch.Tensor:
    return from_numpy({"x": x}, "cpu")["x"]


@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("n", [1, 255, 256, 257, 4096, 100_001])
def test_bit_equal_to_numpy_branch(dtype, n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.uniform(1e-3, 50.0)).astype(NP[dtype])
    q, s = quantize_rows(_torch(x))
    qn, sn = _numpy_ref(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), qn)
    assert np.array_equal(s.numpy().view(np.uint32), sn.view(np.uint32))


def test_ties_round_half_to_even():
    """Rows built so x / scale lands exactly on .5: rint, not round-away."""
    x = np.zeros(256, np.float32)
    x[0] = 127.0  # scale = 1.0
    x[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    q, s = quantize_rows(torch.from_numpy(x))
    qn, sn = _numpy_ref(x)
    assert float(s[0]) == 1.0
    assert q[:9].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126]
    assert np.array_equal(q.numpy(), qn) and np.array_equal(s.numpy(), sn)


def test_all_zero_row_scale_floor():
    x = np.zeros(700, np.float32)
    x[300:310] = 1.0  # row 1 non-zero; rows 0 and 2 (ragged) all zero
    q, s = quantize_rows(torch.from_numpy(x))
    assert s[0].item() == np.float32(1e-12) and s[2].item() == np.float32(1e-12)
    qn, sn = _numpy_ref(x)
    assert np.array_equal(q.numpy(), qn) and np.array_equal(s.numpy(), sn)


def test_extreme_magnitudes():
    x = np.full(1000, 3.0e38, np.float32)
    x[::7] = -3.0e38
    x[500:600] = 1e-40  # subnormal rows
    q, s = quantize_rows(torch.from_numpy(x))
    qn, sn = _numpy_ref(x)
    assert np.array_equal(q.numpy(), qn)
    assert np.array_equal(s.numpy().view(np.uint32), sn.view(np.uint32))


@pytest.mark.parametrize("dtype", sorted(NP))
def test_against_pallas_kernel_interpret(dtype):
    import jax.numpy as jnp

    from repro.kernels.quant.kernel import quantize_rows as pallas_quantize_rows

    rows = (np.random.default_rng(5).standard_normal((8, 256)) * 2).astype(NP[dtype])
    qk, sk = pallas_quantize_rows(jnp.asarray(rows.astype(np.float32)), interpret=True)
    q, s = quantize_rows(_torch(rows.reshape(-1)))
    assert np.max(np.abs(q.numpy().reshape(8, 256).astype(np.int32) - np.asarray(qk, np.int32))) <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-6)


@pytest.mark.parametrize("dtype", sorted(NP))
def test_dequantize_matches_numpy_decode(dtype):
    n = 1000
    x = (np.random.default_rng(3).standard_normal(n) * 4).astype(NP[dtype])
    q, s = quantize_rows(_torch(x))
    got = dequantize_rows(q[:n], s, n, getattr(torch, dtype))
    qn, sn = _numpy_ref(x)
    want = (qn.reshape(-1, 256).astype(np.float32) * sn[:, None]).reshape(-1)[:n].astype(NP[dtype])
    assert got.numel() == n
    assert np.array_equal(got.reshape(-1).view(torch.uint8).numpy(), want.view(np.uint8))


def test_cpu_wrapper_is_plain_version_and_validates():
    x = torch.randn(777, generator=torch.Generator().manual_seed(0))
    q1, s1 = quantize_rows(x)
    q2, s2 = quantize_rows_plain(x)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    with pytest.raises(TypeError):
        quantize_rows(torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        quantize_rows(torch.zeros(0))
    with pytest.raises(ValueError):
        quantize_rows(torch.zeros(16)[::2])
