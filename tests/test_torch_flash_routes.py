"""The routes of the port's flash attention, on the CPU.

``flash_attention`` sends a call on the card to one of three kernels, by
dtype and shape alone (``_route``): the split-KV decode kernel when the
packed query rows fit one tile (``Sq * G <= 64``), the tensor-core kernel
for the rest in bf16 at head_dim 64/128, and the f32 kernel
otherwise. Here, without a card: which route each of ``chip_smoke.py``'s
cases takes, the decode route's split planner at the cache lengths where
its edges fall, the decode kernel's algorithm (``split_kv_plain``: per
split partials, then the log-sum-exp merge) against ``attention_plain``,
the JAX oracle ``attention_ref``, the Pallas kernel in interpret mode and
the JAX models' ``chunked_attention``, and the wrapper's checks. Inputs
come from numpy with a seed; f32 tolerance 2e-5, as ``test_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = 2e-5
BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


def _meta(b, hq, hkv, sq, sk, d, dtype):
    return (torch.empty((b, hq, sq, d), dtype=dtype, device="meta"),
            torch.empty((b, hkv, sk, d), dtype=dtype, device="meta"))


#: chip_smoke.py's flash cases: (label, (b, hq, hkv, sq, sk, d, dtype), route)
ROUTE_CASES = [
    ("serving prefill", (16, 32, 8, 512, 512, 128, BF16), "tensor_core"),
    ("serving decode step", (16, 32, 8, 1, 576, 128, BF16), "decode"),
    ("decode at 4096", (2, 32, 8, 1, 4096, 128, BF16), "decode"),
    ("long prefill", (1, 32, 8, 4096, 4096, 128, BF16), "tensor_core"),
    ("offset prefill", (2, 32, 8, 64, 576, 128, BF16), "tensor_core"),
    ("test_kernels 2x4/2 128 d64 bf16", (2, 4, 2, 128, 128, 64, BF16), "tensor_core"),
    ("test_kernels 2x4/2 128 d64 f32", (2, 4, 2, 128, 128, 64, F32), "f32"),
    ("test_kernels 8/8 256 d128 bf16 softcap", (1, 8, 8, 256, 256, 128, BF16), "tensor_core"),
    ("test_kernels 8/8 256 d128 f32 softcap", (1, 8, 8, 256, 256, 128, F32), "f32"),
    ("test_kernels 4/1 96x160 d64 bf16", (2, 4, 1, 96, 160, 64, BF16), "tensor_core"),
    ("test_kernels 4/1 96x160 d64 f32", (2, 4, 1, 96, 160, 64, F32), "f32"),
    ("test_kernels d256 bf16", (1, 2, 2, 384, 384, 256, BF16), "tensor_core"),
    ("test_kernels d256 f32", (1, 2, 2, 384, 384, 256, F32), "f32"),
    ("test_kernels 16/4 64 d128 bf16", (1, 16, 4, 64, 64, 128, BF16), "tensor_core"),
    ("test_kernels 16/4 64 d128 f32", (1, 16, 4, 64, 64, 128, F32), "f32"),
    ("test_kernels 2/2 200 d64 bf16", (1, 2, 2, 200, 200, 64, BF16), "tensor_core"),
    ("16 rows of 4 heads: still one tile", (1, 16, 4, 16, 64, 128, BF16), "decode"),
    ("17 rows of 4 heads: two tiles", (1, 16, 4, 17, 64, 128, BF16), "tensor_core"),
    ("64 rows, one head a group", (1, 8, 8, 64, 64, 64, F32), "decode"),
    ("decode f32", (2, 32, 8, 1, 576, 128, F32), "decode"),
    ("decode head_dim 256", (1, 8, 2, 1, 300, 256, BF16), "decode"),
]


@pytest.mark.parametrize("label,shape,route", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_route_of_each_case(label, shape, route):
    q, k = _meta(*shape)
    assert fa._route(q, k) == route


#: (kv_end, batch x KV heads) -> (keys_per_split, nsplit)
PLANS = {
    (1, 128): (64, 1), (63, 128): (64, 1), (64, 128): (64, 1), (65, 128): (64, 2),
    (513, 128): (128, 5), (576, 128): (128, 5), (4096, 128): (832, 5), (4096, 16): (128, 32),
    (1, 1): (64, 1), (576, 1): (64, 9), (100_000, 1): (64 * 25, 63), (576, 4096): (576, 1),
    (576, 16): (64, 9), (4096, 2): (64, 64),
}


@pytest.mark.parametrize("kv_end,bkv", sorted(PLANS), ids=lambda x: str(x))
def test_split_plan(kv_end, bkv):
    keys, nsplit = fa.split_plan(kv_end, bkv)
    assert (keys, nsplit) == PLANS[(kv_end, bkv)]
    assert keys % fa.TILE_KEYS == 0 and 1 <= nsplit <= fa.MAX_SPLITS
    # the splits tile [0, kv_end) and none is empty
    assert (nsplit - 1) * keys < kv_end <= nsplit * keys
    assert nsplit * bkv <= max(fa.MAX_SPLIT_BLOCKS, bkv)


def test_serving_decode_step_fills_the_card():
    """The serving decode step (16 x 8 KV heads at a 576-key cache) gets
    one block a (batch, KV head, 128-key split): 640 blocks, about one
    wave of the kernel on 132 SMs."""
    keys, nsplit = fa.split_plan(fa.live_end(1, True, 575, 576), 16 * 8)
    assert (keys, nsplit * 16 * 8) == (128, 640)


@pytest.mark.parametrize("sq,causal,q_offset,kv_len,want", [
    (1, True, 575, 576, 576), (1, True, 0, 576, 1), (8, True, 60, 100, 68), (8, False, 60, 100, 100),
    (64, True, 300, 364, 364), (4, True, 0, 2, 2),
])
def test_live_end(sq, causal, q_offset, kv_len, want):
    assert fa.live_end(sq, causal, q_offset, kv_len) == want


def _inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _t(a):
    return torch.from_numpy(a.copy())


def _close(got, want):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want, np.float32), rtol=TOL, atol=TOL)


#: decode-route shapes (Sq * G <= 64): (b, hq, hkv, sq, sk, d, q_offset, kv_len)
DECODE_SHAPES = [
    (2, 8, 2, 1, 200, 64, 0, 1),  # one live key
    (2, 8, 2, 1, 200, 64, 62, 63),
    (2, 8, 2, 1, 200, 64, 63, 64),  # a whole tile
    (2, 8, 2, 1, 200, 64, 64, 65),  # one key into the second split
    (1, 32, 8, 1, 600, 128, 512, 513),
    (1, 32, 8, 1, 576, 128, 575, 576),  # the serving step at a full cache
    (1, 16, 4, 4, 300, 64, 100, 104),  # a short chunk behind a cache
    (1, 8, 2, 8, 160, 32, 60, 68),  # rows at 60..67: the second split holds no key for rows < 64
    (2, 4, 1, 16, 140, 64, 120, 136),
    (1, 8, 8, 64, 130, 16, 66, 130),  # 64 rows, one head a group
]


@pytest.mark.parametrize("keys_per_split", [None, 16, 64])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_kv_equals_plain_and_chunked_attention(shape, softcap, keys_per_split):
    b, hq, hkv, sq, sk, d, q_offset, kv_len = shape
    assert sq * hq // hkv <= fa.DECODE_ROWS
    q, k, v = _inputs(kv_len * 3 + sq, b, hq, hkv, sq, sk, d)
    kw = dict(causal=True, softcap=softcap, q_offset=q_offset, kv_len=kv_len)
    got = fa.split_kv_plain(_t(q), _t(k), _t(v), keys_per_split=keys_per_split, **kw)
    _close(got, fa.attention_plain(_t(q), _t(k), _t(v), **kw).numpy())
    want = chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, q_offset=q_offset,
        kv_len=jnp.asarray(kv_len), attn_softcap=softcap, block_k=16,
    )
    _close(got, want)


#: (b, hq, hkv, sq, sk, d, causal, softcap), q at position 0 and every key
#: valid, as the TPU kernel takes them
TPU_SHAPES = [
    (2, 8, 2, 16, 16, 64, True, 0.0),
    (1, 16, 4, 16, 130, 128, False, 0.0),
    (2, 4, 1, 16, 200, 64, False, 50.0),
    (1, 8, 8, 64, 64, 32, True, 0.0),
    (1, 2, 2, 32, 300, 256, False, 0.0),
]


@pytest.mark.parametrize("keys_per_split", [None, 16])
@pytest.mark.parametrize("shape", TPU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_kv_equals_jax_oracle_and_pallas(shape, keys_per_split):
    b, hq, hkv, sq, sk, d, causal, cap = shape
    q, k, v = _inputs(sk + d, b, hq, hkv, sq, sk, d)
    got = fa.split_kv_plain(_t(q), _t(k), _t(v), causal=causal, softcap=cap, keys_per_split=keys_per_split)
    _close(got, attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, softcap=cap))
    _close(got, jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, softcap=cap,
                          interpret=True))


def test_split_with_no_live_key_drops_out_exactly():
    """Rows at positions 60..67 against 16-key splits: the split [64, 80)
    holds no live key for rows 60..63, whose partial there has m = -1e30;
    the merge weights it exp(-1e30 - M) = 0, and keys past kv_len, set to
    huge values, change nothing."""
    q, k, v = (_t(a) for a in _inputs(7, 1, 8, 2, 8, 96, 64))
    kw = dict(causal=True, q_offset=60, kv_len=68, keys_per_split=16)
    out = fa.split_kv_plain(q, k, v, **kw)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 68:] = 1e4
    v2[:, :, 68:] = -1e4
    assert torch.equal(fa.split_kv_plain(q, k2, v2, **kw), out)
    _close(out, fa.attention_plain(q, k, v, causal=True, q_offset=60, kv_len=68).numpy())


def test_split_kv_in_bf16_within_the_bf16_tolerance():
    q, k, v = (_t(a).to(BF16) for a in _inputs(11, 2, 32, 8, 1, 576, 128))
    kw = dict(causal=True, q_offset=575, kv_len=576)
    got = fa.split_kv_plain(q, k, v, **kw)
    assert got.dtype == BF16
    torch.testing.assert_close(got.float(), fa.attention_plain(q, k, v, **kw).float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("route,shape,err,match", [
    ("decode", (1, 16, 4, 17, 64, 128, BF16), ValueError, "decode route"),
    ("tensor_core", (1, 16, 4, 128, 128, 128, F32), TypeError, "bfloat16"),
    ("tensor_core", (1, 2, 2, 384, 384, 96, BF16), ValueError, "head_dim"),
    ("f32", (1, 128, 1, 64, 64, 64, F32), ValueError, "Hq/Hkv"),
    ("flash", (1, 4, 2, 8, 8, 64, F32), ValueError, "unknown route"),
    ("decode", (1, 4, 2, 1, 8, 32, F32), ValueError, "head_dim"),
])
def test_launch_route_refuses_what_its_kernel_lacks(route, shape, err, match):
    b, hq, hkv, sq, sk, d, dtype = shape
    q, k, v = (torch.zeros(s, dtype=dtype) for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    with pytest.raises(err, match=match):
        fa.launch_route(route, q, k, v)


@pytest.mark.parametrize("route", fa.ROUTES)
def test_launch_route_needs_the_card(route):
    q, k, v = (torch.zeros(s, dtype=BF16) for s in ((1, 4, 1, 64), (1, 1, 8, 64), (1, 1, 8, 64)))
    with pytest.raises(TypeError, match="unsupported device"):
        fa.launch_route(route, q, k, v)


def test_cpu_calls_launch_no_route():
    counters = [fa.LAUNCHES, *fa.ROUTE_LAUNCHES.values()]
    before = [c.value for c in counters]
    for shape in ((1, 8, 2, 1, 64, 64), (1, 8, 2, 40, 40, 64)):
        q, k, v = (_t(a).to(BF16) for a in _inputs(1, *shape))
        fa.flash_attention(q, k, v)
    assert [c.value for c in counters] == before


def _bh(b, h, s, d, dtype=BF16):
    return torch.zeros((b, h, s, d), dtype=dtype)


@pytest.mark.parametrize("label,make,copied", [
    ("contiguous [B,H,S,D]", lambda: _bh(2, 4, 9, 128), False),
    ("the model's v: [B,S,H,D] viewed as [B,H,S,D]", lambda: torch.zeros(2, 9, 8 * 128, dtype=BF16)
     .reshape(2, 9, 8, 128).transpose(1, 2), False),
    ("a layer's slice of a stacked cache", lambda: torch.zeros(3, 2, 8, 576, 128, dtype=BF16)[1], False),
    ("bf16 rows 8 bytes apart from 16-byte alignment", lambda: torch.zeros(2, 4, 9, 132, dtype=BF16)[..., 4:], True),
    ("bf16 base 2 bytes off", lambda: torch.zeros(2 * 4 * 9 * 64 + 1, dtype=BF16)[1:].view(2, 4, 9, 64), True),
    ("f32 rows of 66", lambda: torch.zeros(2, 4, 9, 66)[..., :64], True),
    ("f32 rows of 72", lambda: torch.zeros(2, 4, 9, 72)[..., :64], False),
    ("one query: any sequence stride", lambda: torch.zeros(512).as_strided((2, 4, 1, 64), (256, 64, 3, 1)), False),
    ("unit stride missing in D", lambda: _bh(2, 4, 64, 9).transpose(2, 3), True),
    ("a broadcast gradient: zero strides", lambda: torch.ones(64, dtype=BF16).expand(2, 4, 9, 64), True),
])
def test_aligned_copies_only_what_tma_cannot_read(label, make, copied):
    t = make()
    got = fa._aligned(t)
    assert (got.data_ptr() != t.data_ptr()) == copied
    assert torch.equal(got, t)
    assert got.data_ptr() % 16 == 0 and got.stride(3) == 1


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 192, 256])
@pytest.mark.parametrize("sq", [1, 200])
def test_routes_of_every_dtype_and_head_dim(dtype, d, sq):
    """The forward's and the backward's route from dtype and shape alone,
    and what a call on the card does with them (meta tensors take the CUDA
    branch, so a call the kernels take stops at the device check): head_dim
    192 (with a v of 192) is refused, every other head_dim has a forward and
    a backward on its route; head_dim 80 (hubert's and zamba2's) goes to
    the tensor cores in bf16 and to the CUDA cores otherwise, and a
    decode-sized call at 80 in f32 or bf16 to ``decode``, as at 64/128/256."""
    q, k = _meta(2, 8, 2, sq, 200, d, dtype)
    tc = dtype == BF16 and d in (64, 80, 128, 256)
    decode = sq == 1 and dtype in (F32, BF16) and d in (64, 80, 128, 256)
    assert fa._route(q, k) == ("decode" if decode else "tensor_core" if tc else "f32")
    assert fa._route(q, k, grad=True) == ("tensor_core" if tc else "f32")
    assert fa._bwd_route(q) == ("tensor_core" if tc else "cuda_core")
    leaves = [q.requires_grad_(), k.requires_grad_(), k.detach().clone().requires_grad_()]
    if d == 192:
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(q.detach(), k.detach(), k.detach())
        with pytest.raises(NotImplementedError, match="192 goes with a v of 128 only"):
            fa.flash_attention(*leaves)
        return
    with pytest.raises(TypeError, match="unsupported device"):
        fa.flash_attention(q.detach(), k.detach(), k.detach())
    with pytest.raises(TypeError, match="unsupported device"):
        fa.flash_attention(*leaves)
    lse = torch.empty(q.shape[:3], dtype=F32, device="meta")
    with pytest.raises(TypeError, match="unsupported device"):
        fa.launch_backward(q.detach(), k.detach(), k.detach(), q.detach(), lse, q.detach())


@pytest.mark.parametrize("dtype,d", [(F32, 128), (F16, 64), (BF16, 32), (BF16, 16)])
def test_tensor_core_backward_refuses_what_it_lacks(dtype, d):
    q, k = _meta(1, 4, 2, 8, 8, d, dtype)
    lse = torch.empty(q.shape[:3], dtype=F32, device="meta")
    with pytest.raises(ValueError, match="tensor_core route takes bfloat16"):
        fa.launch_backward(q, k, k, q, lse, q, route="tensor_core")
    with pytest.raises(ValueError, match="unknown route"):
        fa.launch_backward(q, k, k, q, lse, q, route="wgmma")


def test_backward_counters_name_each_routes_kernels():
    assert sorted(fa.BWD_LAUNCHES) == ["cuda_core/dkdv", "cuda_core/dkdv_dq", "cuda_core/dq", "cuda_core/pre",
                                       "tensor_core/dkdv", "tensor_core/dkdv_dq", "tensor_core/dq",
                                       "tensor_core/pre"]


#: deepseek-v3's expanded MLA attention: q/k of 128 + 64, v of 128, 128
#: heads (Hq = Hkv: every head has its own K and V)
MLA_ROUTE_CASES = [
    ("served prefill", (4, 128, 128, 512, 512, 192, 128, BF16), "tensor_core"),
    ("one query", (2, 128, 128, 1, 40, 192, 128, BF16), "tensor_core"),
    ("S = 77", (1, 16, 16, 77, 77, 192, 128, BF16), "tensor_core"),
    ("GQA group of 4", (1, 16, 4, 64, 64, 192, 128, BF16), "tensor_core"),
    ("f32", (1, 16, 16, 77, 77, 192, 128, F32), "f32"),
    ("f16", (1, 16, 16, 77, 77, 192, 128, F16), "f32"),
    ("another pair", (1, 8, 8, 64, 64, 128, 64, BF16), "f32"),
    ("the reduced config's 24/16", (1, 4, 4, 9, 9, 24, 16, BF16), "f32"),
    ("24/16 in f32", (8, 4, 4, 64, 64, 24, 16, F32), "f32"),
    ("24/16 in f16, G 4", (1, 8, 2, 77, 77, 24, 16, F16), "f32"),
    ("24 with v 8", (1, 4, 4, 9, 9, 24, 8, F32), "f32"),
]
#: the pairs a kernel takes, forward and backward: (d, dv, dtype) -> the backward's route
MLA_TRAINED = {(192, 128, BF16): "tensor_core", **{(24, 16, t): "cuda_core" for t in (F32, BF16, F16)}}


def _mla_meta(b, hq, hkv, sq, sk, d, dv, dtype):
    q, k = _meta(b, hq, hkv, sq, sk, d, dtype)
    return q, k, torch.empty((b, hkv, sk, dv), dtype=dtype, device="meta")


@pytest.mark.parametrize("label,shape,route", MLA_ROUTE_CASES, ids=[c[0] for c in MLA_ROUTE_CASES])
def test_mla_widths_route_only_to_the_tensor_core_forward(label, shape, route):
    """bf16 at (D, Dv) = (192, 128) goes to the tensor-core forward at any
    Sq (the decode route takes no Dv != D) and to the tensor-core backward
    (``bwd_kernels`` names pre and the one dkdv_dq launch); (24, 16) goes
    to the f32 forward and the cuda_core backward (pre, dkdv, dq) in every
    dtype; every other pair goes to the f32 route, which refuses it naming
    the route and the shape, and so does the backward, naming the pair
    ((192, 128) in f32 or f16 among them). A call the kernels take stops at
    the device check (meta tensors take the CUDA branch)."""
    q, k, v = _mla_meta(*shape)
    d, dv, dtype = q.shape[-1], v.shape[-1], q.dtype
    assert fa._route(q, k, v=v) == route
    assert fa._route(q, k, grad=True, v=v) == route
    trained = MLA_TRAINED.get((d, dv, dtype))
    assert fa._bwd_route(q, v) == (trained or "cuda_core")
    if route == "tensor_core":
        with pytest.raises(TypeError, match="unsupported device"):  # every check passed
            fa.flash_attention(q, k, v, causal=True)
        for other in ("decode", "f32"):
            with pytest.raises(ValueError, match=rf"the {other} route takes v's head_dim.*\(192, 128\)"):
                fa.launch_route(other, q, k, v)
    elif (d, dv) in fa.CC_DIM_PAIRS:
        with pytest.raises(TypeError, match="unsupported device"):
            fa.flash_attention(q, k, v, causal=True)
        with pytest.raises(ValueError, match=r"the decode route takes v's head_dim.*\(24, 16\)"):
            fa.launch_route("decode", q, k, v)
    else:
        with pytest.raises(ValueError, match=r"the f32 route takes v's head_dim.*\(\d+, \d+\) of q"):
            fa.flash_attention(q, k, v, causal=True)
    if route != "tensor_core":
        with pytest.raises((ValueError, TypeError), match=r"tensor_core route takes (\(q/k, v\) head_dim|bfloat16)"):
            fa.launch_route("tensor_core", q, k, v)
    lse = torch.empty(q.shape[:3], dtype=F32, device="meta")
    dout = torch.empty((*q.shape[:3], dv), dtype=dtype, device="meta")
    if trained:
        assert fa.bwd_kernels(d, dv) == (("pre", "dkdv_dq") if trained == "tensor_core" else ("pre", "dkdv", "dq"))
        fa._check_backward(q, v)
        with pytest.raises(TypeError, match="unsupported device"):  # every check passed
            fa.flash_attention(q.requires_grad_(), k, v, causal=True)
        with pytest.raises(TypeError, match="unsupported device"):
            fa.launch_backward(q.detach(), k, v, dout, lse, dout)
        other = "cuda_core" if trained == "tensor_core" else "tensor_core"
        with pytest.raises(ValueError, match=rf"the {other} route takes .*got .*\({d}, {dv}\)"):
            fa.launch_backward(q.detach(), k, v, dout, lse, dout, route=other)
        return
    with pytest.raises(NotImplementedError, match=rf"got \({d}, {dv}\) in {dtype}"):
        fa.flash_attention(q.requires_grad_(), k, v, causal=True)
    with pytest.raises(NotImplementedError, match=rf"got \({d}, {dv}\)"):
        fa._check_backward(q.detach(), v)  # what launch_backward checks on the card


def test_tensor_core_dim_pairs():
    assert fa.TC_DIM_PAIRS == ((64, 64), (80, 80), (128, 128), (256, 256), (192, 128))
    assert all((d, d) in fa.TC_DIM_PAIRS for d in fa.TC_HEAD_DIMS)


def test_v_must_share_batch_heads_and_keys_with_k():
    q, k = _meta(1, 4, 4, 8, 8, 192, BF16)
    for v_shape in ((1, 4, 9, 128), (1, 2, 8, 128), (2, 4, 8, 128)):
        with pytest.raises(ValueError, match="v \\[B,Hkv,Sk,Dv\\]"):
            fa.flash_attention(q, k, torch.empty(v_shape, dtype=BF16, device="meta"))


#: hubert-xlarge's attention at head_dim 80 (16 query and 16 KV heads,
#: bidirectional): its encode, its training shapes, a decode-sized call and
#: small edges: (b, hq, hkv, sq, sk)
HEAD_DIM_80_SHAPES = [(8, 16, 16, 1000, 1000), (4, 16, 16, 1000, 1000), (2, 16, 16, 1, 1000), (1, 4, 1, 16, 64),
                      (1, 2, 2, 77, 77)]


@pytest.mark.parametrize("dtype", [BF16, F32, F16])
@pytest.mark.parametrize("shape", HEAD_DIM_80_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_head_dim_80_routes(dtype, shape):
    """bf16 at head_dim 80 goes to the tensor_core forward and backward,
    f32 and f16 to the f32 forward and the cuda_core backward, at every
    shape; a decode-sized call (Sq x G <= 64) in f32 or bf16 goes to the
    decode route's split kernel at 80 (zamba2's decode), in f16 to ``f32``.
    Every check of the forward and the backward passes (meta tensors stop
    at the device check), the decode route's too where it takes the call."""
    b, hq, hkv, sq, sk = shape
    q, k = _meta(b, hq, hkv, sq, sk, 80, dtype)
    fwd = "tensor_core" if dtype == BF16 else "f32"
    small = sq * hq // hkv <= fa.DECODE_ROWS
    assert fa._route(q, k) == ("decode" if small and dtype != F16 else fwd)
    assert fa._route(q, k, grad=True) == fwd
    assert fa._bwd_route(q) == ("tensor_core" if dtype == BF16 else "cuda_core")
    assert fa.bwd_kernels(80) == ("pre", "dkdv", "dq")
    fa._check_backward(q)
    with pytest.raises(TypeError, match="unsupported device"):
        fa.launch_route(fwd, q, k, k, causal=False, with_lse=True)
    lse = torch.empty(q.shape[:3], dtype=F32, device="meta")
    with pytest.raises(TypeError, match="unsupported device"):
        fa.launch_backward(q, k, k, q, lse, q, causal=False)
    if dtype == F16:
        with pytest.raises(TypeError, match="decode route takes float32 or bfloat16"):
            fa.launch_route("decode", q, k, k)
    elif not small:
        with pytest.raises(ValueError, match=r"the decode route takes Sq \* Hq/Hkv <= 64"):
            fa.launch_route("decode", q, k, k)
    else:
        with pytest.raises(TypeError, match="unsupported device"):
            fa.launch_route("decode", q, k, k)
    if dtype != BF16:
        with pytest.raises(TypeError, match="tensor_core route takes bfloat16"):
            fa.launch_route("tensor_core", q, k, k)


@pytest.mark.parametrize("route", ["decode", "f32"])
def test_routes_refuse_head_dim_96_naming_it(route):
    q, k = _meta(1, 4, 4, 1, 64, 96, F32)
    with pytest.raises(ValueError, match=rf"the {route} route takes head_dim in .*, got head_dim 96$"):
        fa.launch_route(route, q, k, k)
    with pytest.raises(NotImplementedError, match=r"got \(96, 96\) .*no kernel has head_dim 96"):
        fa._check_backward(q)


#: a ring's valid slots cut into blocks: (batch, hq, hkv, slots, head_dim, blocks, kv_len, softcap)
MERGE_CASES = [
    (1, 4, 4, 8, 16, 2, 8, 0.0),  # every slot valid, two blocks (the reduced zamba2's ring on 2 data ranks)
    (1, 4, 4, 8, 16, 2, 3, 0.0),  # kv_len < W: the second block has no valid slot
    (2, 8, 2, 64, 32, 4, 37, 0.0),  # GQA, kv_len in the third block, the fourth empty
    (1, 32, 32, 256, 80, 16, 256, 0.0),  # zamba2's widths, 16 blocks
    (2, 4, 4, 48, 64, 3, 48, 20.0),  # a softcap
    (1, 4, 2, 40, 16, 1, 25, 0.0),  # one block: the call itself
]


@pytest.mark.parametrize("case", MERGE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_merge_of_blocks_equals_the_whole_cache(case):
    """``merge_attention`` of each key block's ``(out, lse)`` (an empty
    block: out 0, lse -inf, as a ring's rank with no valid slot
    contributes) equals ``attention_plain`` over the whole cache, and its
    lse ``attention_lse_plain``'s, within 2e-5 (f32); one block returns
    that block's call bit for bit."""
    b, hq, hkv, w, d, nb, kv_len, cap = case
    q, k, v = (_t(a) for a in _inputs(5 + w, b, hq, hkv, 1, w, d))
    kw = dict(causal=False, softcap=cap)
    n = w // nb
    outs, lses = [], []
    for i in range(nb):
        valid = min(kv_len - i * n, n)
        if valid > 0:
            o, lse = fa.flash_attention_lse(q, k[:, :, i * n:(i + 1) * n], v[:, :, i * n:(i + 1) * n], kv_len=valid,
                                            **kw)
        else:
            o, lse = torch.zeros_like(q), torch.full((b, hq, 1), float("-inf"))
        outs.append(o)
        lses.append(lse)
    out, lse = fa.merge_attention(torch.stack(outs), torch.stack(lses))
    if nb == 1:
        assert torch.equal(out, outs[0]) and torch.equal(lse, lses[0])
    np.testing.assert_allclose(out.numpy(), fa.attention_plain(q, k, v, kv_len=kv_len, **kw).numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), fa.attention_lse_plain(q, k, kv_len=kv_len, **kw).numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("kv_len", [1, 2, 3, 5, 8])
def test_merge_one_mesh_dimension_at_a_time_equals_the_whole_cache(kv_len):
    """A ring of 8 slots in 4 blocks of 2, the blocks a (pod, data) 2x2
    mesh splits the slots into (block ``2 * pod + data``), merged as the
    sharded ring step merges them: over the pod dimension first (blocks
    ``{d, 2 + d}``), then over the data one. Early in the ring a whole
    first merge sees no valid slot (``kv_len`` 1 and 2: blocks 1 and 3);
    its result is empty (out 0, lse -inf, no NaN) and drops out of the
    second. The result equals ``attention_plain`` over the whole ring and
    its lse ``attention_lse_plain``'s, within 2e-5 (f32)."""
    q, k, v = (_t(a) for a in _inputs(41, 1, 4, 2, 1, 8, 16))
    kw = dict(causal=False)
    parts = []
    for blk in range(4):
        valid = min(kv_len - 2 * blk, 2)
        if valid > 0:
            parts.append(fa.flash_attention_lse(q, k[:, :, 2 * blk:2 * blk + 2], v[:, :, 2 * blk:2 * blk + 2],
                                                kv_len=valid, **kw))
        else:
            parts.append((torch.zeros_like(q), torch.full((1, 4, 1), float("-inf"))))
    firsts = [fa.merge_attention(torch.stack([parts[d][0], parts[2 + d][0]]),
                                 torch.stack([parts[d][1], parts[2 + d][1]])) for d in range(2)]
    if kv_len <= 2:
        assert torch.equal(firsts[1][0], torch.zeros_like(q))
        assert torch.equal(firsts[1][1], torch.full((1, 4, 1), float("-inf")))
    out, lse = fa.merge_attention(torch.stack([o for o, _ in firsts]), torch.stack([s for _, s in firsts]))
    np.testing.assert_allclose(out.numpy(), fa.attention_plain(q, k, v, kv_len=kv_len, **kw).numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), fa.attention_lse_plain(q, k, kv_len=kv_len, **kw).numpy(), rtol=TOL,
                               atol=TOL)


def test_flash_attention_lse_on_the_cpu_is_the_plain_pair():
    """On the CPU the wrapper and its operator return ``attention_plain``'s
    output and ``attention_lse_plain``'s lse, bit for bit."""
    q, k, v = (_t(a) for a in _inputs(3, 2, 8, 2, 1, 40, 64))
    kw = dict(causal=True, q_offset=30, kv_len=31)
    want = (fa.attention_plain(q, k, v, **kw), fa.attention_lse_plain(q, k, **kw))
    for got in (fa.flash_attention_lse(q, k, v, **kw), fa.flash_attention_lse_op(q, k, v, **kw)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
