"""The port's attention against the JAX package's, on the CPU.

``attention_plain`` (the plain version the CUDA kernel is held against on
the card) must equal the JAX oracle ``attention_ref`` and the Pallas
kernel ``flash_attention`` in interpret mode at every shape of
``tests/test_kernels.py``, and the jnp ``chunked_attention`` of the JAX
models with ``q_offset``/``kv_len`` at decode and offset-prefill shapes.
Inputs come from numpy with a seed. Tolerances are ``test_kernels.py``'s:
2e-5 in f32, 2e-2 in bf16 (relative and absolute, as ``assert_allclose``);
2e-3 in f16 (see ``TOL``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402

#: f16 (not in test_kernels.py's sweep): both sides compute in f32 and
#: round once to f16 (2^-11 relative), so they differ by at most one f16
#: ulp of the output, under 1e-3 of it
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-3}

#: (b, hq, hkv, sq, sk, d, causal, softcap): tests/test_kernels.py's sweep
KERNEL_SHAPES = [
    (2, 4, 2, 128, 128, 64, True, 0.0),
    (1, 8, 8, 256, 256, 128, True, 50.0),  # gemma2-style softcap
    (2, 4, 1, 96, 160, 64, False, 0.0),  # ragged, cross-length, MQA
    (1, 2, 2, 384, 384, 256, True, 0.0),  # gemma2 head_dim 256
    (1, 16, 4, 64, 64, 128, True, 0.0),  # GQA 4:1
    (1, 2, 2, 128, 128, 64, True, 0.0),  # test_dtypes
    (1, 2, 2, 200, 200, 64, True, 0.0),  # test_block_shape_sweep
]


def _inputs(seed, b, hq, hkv, sq, sk, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [
        rng.standard_normal(s).astype(np.float32)
        for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    ]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    elif dtype == "float16":
        arrs = [a.astype(np.float16) for a in arrs]
    return arrs


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.float().numpy()


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_equals_jax_oracle(shape, dtype):
    b, hq, hkv, sq, sk, d, causal, cap = shape
    q, k, v = _inputs(sq + d, b, hq, hkv, sq, sk, d, dtype)
    got = fa.attention_plain(_torch(q), _torch(k), _torch(v), causal=causal, softcap=cap)
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    want = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, softcap=cap)
    _close(_np(got), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_equals_pallas_interpret(shape, dtype):
    b, hq, hkv, sq, sk, d, causal, cap = shape
    q, k, v = _inputs(sq * 3 + d, b, hq, hkv, sq, sk, d, dtype)
    got = fa.attention_plain(_torch(q), _torch(k), _torch(v), causal=causal, softcap=cap)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, softcap=cap, interpret=True)
    _close(_np(got), want, dtype)


#: (b, hq, hkv, sq, sk, d, causal, softcap): the head_dims the reduced
#: configs give (16, 32) and the model's (64, 128), for f16 and the narrow
#: heads the f32 route now takes
NARROW_F16_SHAPES = [
    (2, 4, 4, 64, 64, 16, True, 0.0),  # launch.train's reduced llama3-8b
    (2, 8, 2, 77, 77, 16, True, 0.0),
    (1, 8, 2, 40, 96, 32, False, 0.0),
    (1, 8, 8, 96, 96, 32, True, 30.0),
    (1, 16, 4, 64, 64, 64, True, 0.0),
    (1, 8, 8, 130, 130, 128, True, 50.0),
]


@pytest.mark.parametrize("dtype", ["float16", "float32", "bfloat16"])
@pytest.mark.parametrize("shape", NARROW_F16_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f16_and_narrow_heads_equal_jax(shape, dtype):
    """flash_attention (the plain version on the CPU) against the Pallas
    kernel in interpret mode and attention_ref, in the input dtype."""
    b, hq, hkv, sq, sk, d, causal, cap = shape
    q, k, v = _inputs(sq * 5 + d, b, hq, hkv, sq, sk, d, dtype)
    got = fa.flash_attention(_torch(q), _torch(k), _torch(v), causal=causal, softcap=cap)
    assert got.dtype == {"float16": torch.float16, "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = jax_flash(jq, jk, jv, causal=causal, softcap=cap, interpret=True)
    assert str(pallas.dtype) == dtype
    _close(_np(got), pallas.astype(jnp.float32), dtype)
    _close(_np(got), attention_ref(jq, jk, jv, causal=causal, softcap=cap).astype(jnp.float32), dtype)


#: (b, hq, hkv, sq, sk, d, q_offset, kv_len): a decode step against a
#: cache of sk slots, and offset prefills of a chunk behind a prefix
OFFSET_SHAPES = [
    (2, 8, 2, 1, 40, 16, 0, 1),
    (2, 8, 2, 1, 40, 16, 16, 17),
    (2, 8, 2, 1, 40, 16, 39, 40),
    (1, 32, 8, 1, 72, 128, 63, 64),
    (1, 4, 1, 1, 130, 64, 128, 129),
    (2, 4, 2, 8, 48, 64, 20, 28),
    (1, 16, 4, 5, 64, 32, 0, 5),
    (1, 8, 8, 16, 33, 64, 17, 33),
]


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("shape", OFFSET_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_equals_chunked_attention_with_offsets(shape, softcap):
    b, hq, hkv, sq, sk, d, q_offset, kv_len = shape
    q, k, v = _inputs(q_offset * 7 + kv_len, b, hq, hkv, sq, sk, d)
    got = fa.flash_attention(
        _torch(q), _torch(k), _torch(v), causal=True, softcap=softcap, q_offset=q_offset, kv_len=kv_len
    )
    want = chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, q_offset=q_offset,
        kv_len=jnp.asarray(kv_len), attn_softcap=softcap, block_k=16,
    )
    _close(_np(got), want, "float32")


def test_keys_past_kv_len_do_not_matter():
    q, k, v = (_torch(a) for a in _inputs(5, 1, 4, 2, 1, 32, 64))
    out = fa.attention_plain(q, k, v, q_offset=9, kv_len=10)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 10:] = 1e4
    v2[:, :, 10:] = -1e4
    assert torch.equal(fa.attention_plain(q, k2, v2, q_offset=9, kv_len=10), out)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    q, k, v = (_torch(a) for a in _inputs(1, 2, 8, 2, 24, 24, 64, "bfloat16"))
    before = fa.LAUNCHES.value
    got = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, fa.attention_plain(q, k, v, causal=True))
    assert fa.LAUNCHES.value == before


@pytest.mark.parametrize(
    "why,kwargs,match",
    [
        ("kv_len past the keys", dict(kv_len=25), "kv_len"),
        ("kv_len 0", dict(kv_len=0), "kv_len"),
        ("negative offset", dict(q_offset=-1), "q_offset"),
        ("negative softcap", dict(softcap=-1.0), "softcap"),
    ],
)
def test_wrapper_refuses_bad_arguments(why, kwargs, match):
    q, k, v = (_torch(a) for a in _inputs(2, 1, 4, 2, 3, 24, 64))
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v, **kwargs)


def test_wrapper_refuses_bad_shapes_and_dtypes():
    q, k, v = (_torch(a) for a in _inputs(3, 1, 6, 4, 3, 8, 64))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, v)
    q, k, v = (_torch(a) for a in _inputs(3, 1, 4, 2, 3, 8, 64))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="k = v"):
        fa.flash_attention(q, k, v[:, :, :4])
    with pytest.raises(TypeError, match="unsupported device"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


#: hubert-xlarge's head_dim 80 (its 16 query and 16 KV heads cut to 4):
#: bidirectional as its encoder runs it and causal, at S = 77 (no tile
#: multiple), a GQA group of 2 and a softcap
HEAD_DIM_80_SHAPES = [
    (1, 4, 4, 77, 77, 80, False, 0.0),
    (1, 4, 4, 77, 77, 80, True, 0.0),
    (2, 4, 2, 77, 77, 80, True, 50.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", HEAD_DIM_80_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_head_dim_80_equals_pallas_interpret(shape, dtype):
    """flash_attention at head_dim 80 (the plain version on the CPU, what
    the card's kernels at 80 are held against) against the Pallas kernel
    in interpret mode and attention_ref, scaled by 1/sqrt(80)."""
    b, hq, hkv, sq, sk, d, causal, cap = shape
    q, k, v = _inputs(sq * 11 + d, b, hq, hkv, sq, sk, d, dtype)
    got = fa.flash_attention(_torch(q), _torch(k), _torch(v), causal=causal, softcap=cap)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = jax_flash(jq, jk, jv, causal=causal, softcap=cap, interpret=True)
    _close(_np(got), pallas.astype(jnp.float32), dtype)
    _close(_np(got), attention_ref(jq, jk, jv, causal=causal, softcap=cap).astype(jnp.float32), dtype)


#: (b, hq, hkv, sq, sk, causal, window, q_offset, kv_len) at head_dim 80:
#: the windows the kernels at 80 take, causal and not, with offsets
HEAD_DIM_80_WINDOWS = [
    (1, 4, 4, 77, 77, True, 16, 0, None),
    (1, 4, 2, 77, 77, False, 16, 0, None),
    (1, 4, 4, 20, 90, True, 24, 60, 80),
]


@pytest.mark.parametrize("shape", HEAD_DIM_80_WINDOWS, ids=lambda s: "x".join(map(str, s)))
def test_head_dim_80_windows_equal_chunked_attention(shape):
    b, hq, hkv, sq, sk, causal, window, q_offset, kv_len = shape
    q, k, v = _inputs(sq * 13 + window, b, hq, hkv, sq, sk, 80)
    got = fa.flash_attention(_torch(q), _torch(k), _torch(v), causal=causal, window=window, q_offset=q_offset,
                             kv_len=kv_len)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             window=jnp.asarray(window), q_offset=q_offset,
                             kv_len=None if kv_len is None else jnp.asarray(kv_len), block_k=16)
    _close(_np(got), want, "float32")
