"""The port's checksum (plain PyTorch version, as the CPU runs it) against
the JAX package's host checksum and its Pallas kernel in interpret mode:
exactly equal, over dtypes, ragged lengths, unaligned views and the
zero-fold remap."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.kernels.checksum import fold64, tensor_checksum  # noqa: E402
from repro.transfer.checksum import ZERO_STANDIN as JAX_ZERO_STANDIN  # noqa: E402
from repro.transfer.checksum import checksum as jax_checksum  # noqa: E402

from repro_torch.kernels.checksum import checksum_words, checksum_words_plain  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.transfer.checksum import ZERO_STANDIN, checksum, combine  # noqa: E402

DTYPES = {
    "float32": np.float32,
    "bfloat16": ml_dtypes.bfloat16,
    "float16": np.float16,
    "int32": np.int32,
}


def _array(dtype: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    return (rng.standard_normal(n) * 3.0).astype(DTYPES[dtype])


def _bytes(arr: np.ndarray) -> torch.Tensor:
    return from_numpy({"x": arr}, "cpu")["x"].reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 3, 255, 4097, 70001])
def test_checksum_matches_jax(dtype, n):
    arr = _array(dtype, n, seed=n)
    got = checksum(_bytes(arr))
    assert got == jax_checksum(arr)
    import jax.numpy as jnp

    assert got == fold64(tensor_checksum(jnp.asarray(arr), interpret=True))


@pytest.mark.parametrize("nbytes", [1, 2, 3, 5, 6, 7, 4097, 262147])
def test_ragged_byte_lengths(nbytes):
    raw = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8)
    assert checksum(torch.from_numpy(raw.copy())) == jax_checksum(raw)


@pytest.mark.parametrize("offset", [1, 2, 3, 5])
def test_unaligned_view(offset):
    raw = np.random.default_rng(offset).integers(0, 256, 10_000, dtype=np.uint8)
    t = torch.from_numpy(raw.copy())
    view = t[offset : offset + 7_777]
    assert view.storage_offset() == offset
    assert checksum(view) == jax_checksum(raw[offset : offset + 7_777])


def test_zero_fold_remapped():
    assert ZERO_STANDIN == JAX_ZERO_STANDIN
    zeros = np.zeros(4096, np.uint8)
    assert jax_checksum(zeros) == ZERO_STANDIN
    assert checksum(torch.from_numpy(zeros.copy())) == ZERO_STANDIN
    assert checksum(torch.zeros(0, dtype=torch.uint8)) == jax_checksum(np.zeros(0, np.uint8)) == 0


def test_weight_wraps_past_2_16_words():
    """Position weights wrap at 2^16 words; sums wrap at 2^32. Ones make
    both visible: s1 = n, s2 = sum of the wrapped weights."""
    n = (1 << 17) + 123
    ones = np.full(n, 0xFFFFFFFF, np.uint32)
    assert checksum(torch.from_numpy(ones.view(np.uint8).copy())) == jax_checksum(ones)


def test_cpu_wrapper_is_plain_version():
    buf = _bytes(_array("float32", 999, seed=9))
    assert torch.equal(checksum_words(buf), checksum_words_plain(buf))


def test_wrapper_rejects_non_bytes():
    with pytest.raises(TypeError):
        checksum_words(torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError):
        checksum_words(torch.zeros(16, dtype=torch.uint8)[::2])


def test_combine_matches_jax():
    from repro.transfer.checksum import combine as jax_combine

    sums = [jax_checksum(_array("float32", 100 + i, seed=i)) for i in range(20)]
    sums.append(0xFFFFFFFFFFFFFFFF)
    assert combine(sums) == jax_combine(sums)
