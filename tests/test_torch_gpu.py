"""CUDA kernels of the port against their plain versions on the card, and
one small transfer through the client on the card. Marked ``gpu``: they
skip where there is no CUDA device, and run on the card with

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import checksum as ck  # noqa: E402
from repro_torch.kernels import quant as qk  # noqa: E402
from repro_torch.kernels import repack as rk  # noqa: E402
from repro_torch.kernels.quant import fused as fk  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("nbytes", [1, 3, 4, 5, 15, 16, 17, 4097, 1 << 20, (1 << 20) + 3])
@pytest.mark.parametrize("offset", [0, 1, 3, 16])
def test_checksum_kernel_equals_plain(dev, nbytes, offset):
    g = torch.Generator(device=dev).manual_seed(nbytes + offset)
    raw = torch.randint(0, 256, (nbytes + 32,), dtype=torch.uint8, generator=g, device=dev)
    buf = raw[offset : offset + nbytes]
    before = ck.LAUNCHES.value
    got = ck.checksum_words(buf).to(torch.int64) & 0xFFFFFFFF
    assert ck.LAUNCHES.value == before + 1
    assert torch.equal(got, ck.checksum_words_plain(buf))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 100_001])
def test_quant_kernel_equals_plain(dev, dtype, n):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev, dtype=dtype) * 3
    x[: min(n, 256)] = 0  # an all-zero first row
    q1, s1 = qk.quantize_rows(x)
    q2, s2 = qk.quantize_rows_plain(x)
    assert torch.equal(q1, q2)
    assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))


def test_quant_kernel_unaligned_input(dev):
    x = torch.randn(4096 + 1, device=dev)[1:]  # 4-byte but not 16-byte aligned
    q1, s1 = qk.quantize_rows(x)
    q2, s2 = qk.quantize_rows_plain(x)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)


def test_transfer_on_the_card(dev):
    from repro_torch.core import ReferenceServer, TensorHubClient

    hub = TensorHubClient(ReferenceServer(), chunk_bytes=1 << 20)
    g = torch.Generator(device=dev).manual_seed(0)
    w = {"w": torch.randn(3 << 20, generator=g, device=dev, dtype=torch.bfloat16)}
    pub = hub.open("m", "pub", 1, 0, datacenter="dc0")
    pub.register(w)
    pub.publish(0)
    r = hub.open("m", "r", 1, 0, datacenter="dc1")
    r.register({"w": torch.zeros_like(w["w"])})
    r.replicate(0, timeout=60)
    got = r.store.get("w").float().cpu().numpy()
    want = w["w"].float().cpu().numpy()
    assert r.store.get("w").device == dev
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 0.01


# -- the resharding kernels ----------------------------------------------------


def _staging(dev, nbytes, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (nbytes,), dtype=torch.uint8, generator=g, device=dev)


@pytest.mark.parametrize("src_mod", [0, 1, 2, 3, 8])
@pytest.mark.parametrize("dst_mod", [0, 1, 2, 3, 6])
def test_gather_kernel_alignment_sweep(dev, src_mod, dst_mod):
    """Runs at every offset pair modulo 16: the vector body where they
    agree, narrower words or bytes where not, and byte head and tail."""
    n = 4096 + 13
    raw = _staging(dev, n + 64, src_mod * 16 + dst_mod)
    runs = [(src_mod, 32 + dst_mod, n - 64), (src_mod + n - 64, dst_mod, 32)]
    out_nbytes = 32 + dst_mod + n - 64 + 5
    before = rk.LAUNCHES.value
    got = rk.gather_bytes(raw, runs, out_nbytes)
    assert rk.LAUNCHES.value == before + 1
    assert torch.equal(got, rk.repack_plain(raw, runs, out_nbytes))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("gaps", [False, True])
def test_gather_kernel_random_tilings(dev, seed, gaps):
    out_nbytes = 1 + seed * 100_003
    full = rk.random_runs(seed, out_nbytes)
    runs = full[::2] if gaps else full
    staging = _staging(dev, out_nbytes + 16, seed)
    got = rk.gather_bytes(staging, runs, out_nbytes)
    want = rk.repack_plain(staging, runs, out_nbytes)
    assert torch.equal(got, want)
    if gaps and len(full) > 1:
        assert not rk.covers([(d, k) for _, d, k in runs], out_nbytes)


def _frame(dev, dtype, n, seed, poison=False):
    from repro_torch.transfer.codec import Int8Codec, parse_int8_frame

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=g, device=dev, dtype=torch.float32).mul_(2).to(dtype)
    if poison:
        x[n // 2] = float("inf")  # ships as a passthrough frame
    wire = Int8Codec(quantize=qk.quantize_rows_plain).encode(x.view(torch.uint8), _NAME[dtype])
    return parse_int8_frame(wire)


_NAME = {
    torch.float32: "float32", torch.bfloat16: "bfloat16",
    torch.float16: "float16", torch.float64: "float64",
}


def _pack(frames, specs):
    """(frame index, lead, nbytes, gap) -> placements packed into a unit
    with 24 uncovered bytes at its end."""
    pos, out = 0, []
    for k, lead, nbytes, gap in specs:
        pos += gap
        out.append((frames[k], lead, nbytes, pos))
        pos += nbytes
    return out, pos + 24


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.float64])
def test_fused_kernel_equals_plain(dev, dtype):
    isz = torch.empty((), dtype=dtype).element_size()
    frames = [_frame(dev, dtype, 100_000, 1), _frame(dev, dtype, 513, 2),
              _frame(dev, dtype, 300, 3, poison=True)]
    assert frames[2].is_passthrough
    placements, out_nbytes = _pack(frames, [
        (0, 256 * isz, (100_000 - 256 - 77) * isz, 0),  # lead row and tail trimmed
        (1, 3 * isz, 510 * isz, 2 * isz),  # to the ragged last row, after a gap
        (2, 4 * isz, 200 * isz, 0),  # passthrough overlay
    ])
    before = fk.LAUNCHES.value
    got = fk.fused_repack(placements, out_nbytes)
    assert fk.LAUNCHES.value == before + 1
    assert torch.equal(got, fk.fused_repack_plain(placements, out_nbytes))


def test_fused_kernel_mixed_dtypes_and_bytes(dev):
    frames = [_frame(dev, torch.float64, 600, 5), _frame(dev, torch.bfloat16, 513, 6),
              _frame(dev, torch.float32, 256, 7), _frame(dev, torch.float16, 900, 8)]
    placements, out_nbytes = _pack(frames, [
        (0, 8 * 7, 8 * 500, 0),
        (1, 3, 2 * 400 + 1, 1),  # byte-misaligned lead, length and output offset
        (2, 0, 4 * 256, 3),
        (3, 2 * 256, 2 * 644, 0),
    ])
    got = fk.fused_repack(placements, out_nbytes)
    assert torch.equal(got, fk.fused_repack_plain(placements, out_nbytes))


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_reshard_pull_on_the_card(dev, codec):
    """TP-4 -> TP-2 on the card, cross-axis: raw bit-equal to the source,
    int8 within 1%, through the gather or the fused kernel."""
    import threading

    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.resharding import tp_shard

    g = torch.Generator(device=dev).manual_seed(0)
    glob = {
        "layers/w": torch.randn(6, 256, 512, generator=g, device=dev).to(torch.bfloat16),
        "embed": torch.randn(1024, 256, generator=g, device=dev).to(torch.bfloat16),
    }
    hub = TensorHubClient(ReferenceServer(wan_codec=codec), chunk_bytes=1 << 20)

    def group(name, tp, dc, fill):
        hs = [hub.open("m", name, tp, i, datacenter=dc) for i in range(tp)]
        for h in hs:
            local, lay = tp_shard(glob, h.shard_idx, tp)
            h.register({n: fill(a) for n, a in local.items()}, layout=lay)
        return hs

    def run(hs, fn):
        errs = []
        ts = [threading.Thread(target=lambda h=h: _collect(errs, fn, h)) for h in hs]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errs, errs

    run(group("pub", 4, "dc0", torch.clone), lambda h: h.publish(0))
    subs = group("sub", 2, "dc1", torch.zeros_like)
    counter = rk.LAUNCHES if codec == "raw" else fk.LAUNCHES
    before = counter.value
    run(subs, lambda h: h.replicate(0, timeout=120))
    assert counter.value > before
    for h in subs:
        want, _ = tp_shard(glob, h.shard_idx, 2)
        assert h.intervals_pulled > 0
        for n, w in want.items():
            got = h.store.get(n)
            assert got.device == dev
            if codec == "raw":
                assert torch.equal(got, w), n
            else:
                err = (got.float() - w.float()).abs().max() / w.float().abs().max()
                assert float(err) < 0.01, n


def _collect(errs, fn, h):
    try:
        fn(h)
    except BaseException as e:  # noqa: BLE001 — asserted empty by the caller
        errs.append(e)


# -- flash attention and the serving path -----------------------------------------

#: tests/test_kernels.py's shapes (b, hq, hkv, sq, sk, d, causal, softcap)
_FLASH_SHAPES = [
    (2, 4, 2, 128, 128, 64, True, 0.0),
    (1, 8, 8, 256, 256, 128, True, 50.0),
    (2, 4, 1, 96, 160, 64, False, 0.0),
    (1, 2, 2, 384, 384, 256, True, 0.0),
    (1, 16, 4, 64, 64, 128, True, 0.0),
    (1, 2, 2, 200, 200, 64, True, 0.0),
    (2, 32, 8, 130, 130, 128, True, 0.0),
]
#: test_kernels.py's tolerances, as assert_allclose (relative and absolute);
#: f16 (which test_kernels.py does not sweep) at 2e-3: the kernels compute
#: in f32 and round once, as the plain version does, and f16's rounding
#: (2^-11 relative) is 8x finer than bf16's
_FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}


def _qkv(dev, seed, b, hq, hkv, sq, sk, d, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype) for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _flash_close(got, want, dtype):
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_equals_plain(dev, shape, dtype):
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, d, causal, cap = shape
    q, k, v = _qkv(dev, sq + d, b, hq, hkv, sq, sk, d, dtype)
    before = fa.LAUNCHES.value
    got = fa.flash_attention(q, k, v, causal=causal, softcap=cap)
    assert fa.LAUNCHES.value == before + 1 and got.dtype == dtype and got.device == dev
    _flash_close(got, fa.attention_plain(q, k, v, causal=causal, softcap=cap), dtype)


@pytest.mark.parametrize("kv_len", [1, 17, 64, 65, 128, 129, 513, 576])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_decode_step(dev, kv_len, dtype):
    """One query a head at position kv_len - 1 against a 576-slot cache;
    garbage past kv_len must not leak in."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, kv_len, 2, 32, 8, 1, 576, 128, dtype)
    k[:, :, kv_len:] = 1e4
    v[:, :, kv_len:] = float("nan")
    kw = dict(causal=True, q_offset=kv_len - 1, kv_len=kv_len)
    got = fa.flash_attention(q, k, v, **kw)
    assert torch.isfinite(got).all()
    _flash_close(got, fa.attention_plain(q, k[:, :, :kv_len], v[:, :, :kv_len], **kw), dtype)


@pytest.mark.parametrize("q_offset,sq,kv_len,causal", [(20, 8, 28, True), (0, 5, 5, True), (300, 64, 364, True),
                                                       (7, 33, 40, False), (100, 1, 57, False)])
def test_flash_kernel_offset_prefill(dev, q_offset, sq, kv_len, causal):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, q_offset + sq, 2, 16, 4, sq, 400, 64, torch.float32)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    _flash_close(fa.flash_attention(q, k, v, **kw), fa.attention_plain(q, k, v, **kw), torch.float32)


def test_flash_kernel_strided_views(dev):
    """q, k, v as the model hands them over: [B, S, H, D] projections
    viewed as [B, H, S, D], and a layer's slice of a stacked cache."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(3, 70, 8 * 64, generator=g, device=dev).to(torch.bfloat16)
    q = x.view(3, 70, 8, 64).transpose(1, 2)
    cache = torch.randn(2, 3, 2, 96, 64, generator=g, device=dev).to(torch.bfloat16)
    k, v = cache[1], cache[0]
    got = fa.flash_attention(q, k, v, causal=True, q_offset=10, kv_len=80)
    want = fa.attention_plain(q.contiguous(), k, v, causal=True, q_offset=10, kv_len=80)
    _flash_close(got, want, torch.bfloat16)
    merged = got.transpose(1, 2).reshape(3, 70, 8 * 64)  # the kernel's layout makes this a view
    assert merged.data_ptr() == got.data_ptr()


def test_flash_wrapper_refuses_shapes_the_kernel_lacks(dev):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, 0, 1, 4, 2, 8, 8, 80, torch.float32)  # zamba2's head_dim waits for its slice
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v)


def test_decoder_prefill_and_decode_on_the_card(dev):
    """A small GQA decoder (head_dim 64) on the card in f32: prefill and
    decode through the flash kernel against a forward with the plain
    attention. 1e-4: prefill and decode multiply other shapes than the
    whole-sequence forward, so cuBLAS sums in other orders."""
    import dataclasses

    from repro_torch.configs.llama3_8b import CONFIG
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.lm import DecoderLM
    from repro_torch.models.params import init_params
    from repro_torch.rl.loop import sample_responses

    cfg = dataclasses.replace(CONFIG, num_layers=2, d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024, vocab=1024)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32)
    assert all(t.device == dev for t in params.values())
    prompts = torch.randint(0, cfg.vocab, (3, 20), device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    before = fa.LAUNCHES.value
    seqs, lps, kept = sample_responses(DecoderLM(cfg), params, prompts, 6, torch.Generator(device=dev).manual_seed(2),
                                       return_logits=True)
    assert fa.LAUNCHES.value - before == cfg.num_layers * (1 + 6)
    ref = DecoderLM(cfg, attention=fa.attention_plain).forward(params, {"tokens": seqs})[:, 19:-1]
    torch.testing.assert_close(kept, ref, rtol=1e-4, atol=1e-4)
    lp_ref = torch.log_softmax(ref, -1).gather(-1, seqs[:, 20:, None])[..., 0]
    torch.testing.assert_close(lps, lp_ref, rtol=1e-4, atol=1e-4)


# -- flash attention's three routes ------------------------------------------------


def _routed(fa, route, fn):
    """Run ``fn`` and check it launched ``route``'s kernel once and no other."""
    before = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
    out = fn()
    after = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
    assert {r: after[r] - before[r] for r in after} == {r: int(r == route) for r in after}
    return out


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,cap", [(200, 200, True, 0.0), (130, 130, True, 0.0), (77, 300, False, 0.0),
                                              (256, 256, True, 50.0), (128, 128, False, 30.0), (600, 600, True, 0.0)])
def test_tensor_core_route_equals_plain(dev, d, sq, sk, causal, cap):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, sq * 7 + d, 2, 8, 2, sq, sk, d, torch.bfloat16)
    assert fa._route(q, k) == "tensor_core"
    got = _routed(fa, "tensor_core", lambda: fa.flash_attention(q, k, v, causal=causal, softcap=cap))
    _flash_close(got, fa.attention_plain(q, k, v, causal=causal, softcap=cap), torch.bfloat16)


@pytest.mark.parametrize("q_offset,sq,kv_len", [(300, 64, 364), (20, 100, 120), (0, 65, 65), (500, 40, 540)])
def test_tensor_core_route_offset_prefill(dev, q_offset, sq, kv_len):
    """A chunk behind a cache of 576 slots; slots past kv_len hold garbage
    that TMA must not bring in (the maps end at kv_len)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, q_offset + sq, 2, 32, 8, sq, 576, 128, torch.bfloat16)
    k[:, :, kv_len:] = 1e4
    v[:, :, kv_len:] = float("nan")
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    got = _routed(fa, "tensor_core", lambda: fa.flash_attention(q, k, v, **kw))
    assert torch.isfinite(got).all()
    _flash_close(got, fa.attention_plain(q, k[:, :, :kv_len], v[:, :, :kv_len], **kw), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len,cache", [(1, 576), (63, 576), (64, 576), (65, 576), (576, 576), (4096, 4096)])
def test_decode_route_split_edges(dev, kv_len, cache, dtype):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, kv_len, 2, 32, 8, 1, cache, 128, dtype)
    k[:, :, kv_len:] = 1e4
    v[:, :, kv_len:] = float("nan")
    kw = dict(causal=True, q_offset=kv_len - 1, kv_len=kv_len)
    got = _routed(fa, "decode", lambda: fa.flash_attention(q, k, v, **kw))
    assert torch.isfinite(got).all()
    want = fa.attention_plain(q, k[:, :, :kv_len], v[:, :, :kv_len], **kw)
    _flash_close(got, want, dtype)
    _flash_close(got, fa.split_kv_plain(q, k[:, :, :kv_len], v[:, :, :kv_len], **kw), dtype)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("shape", [(1, 16, 4, 4, 300, 100, 104, True, 0.0), (2, 8, 2, 8, 160, 60, 68, True, 50.0),
                                   (1, 8, 8, 64, 130, 66, 130, True, 0.0), (2, 4, 1, 16, 90, 0, 90, False, 0.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_route_chunks(dev, d, shape, dtype):
    """Several query rows a block (Sq * G <= 64), rows that see no key of
    a split, softcap, non-causal."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, q_offset, kv_len, causal, cap = shape
    q, k, v = _qkv(dev, d + sq, b, hq, hkv, sq, sk, d, dtype)
    kw = dict(causal=causal, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    got = _routed(fa, "decode", lambda: fa.flash_attention(q, k, v, **kw))
    _flash_close(got, fa.attention_plain(q, k, v, **kw), dtype)


def test_f32_route_still_takes_head_dim_256_in_bf16(dev):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, 5, 1, 4, 2, 200, 200, 256, torch.bfloat16)
    got = _routed(fa, "f32", lambda: fa.flash_attention(q, k, v))
    _flash_close(got, fa.attention_plain(q, k, v), torch.bfloat16)


@pytest.mark.parametrize("route", ["tensor_core", "decode"])
def test_routes_take_the_models_strided_views(dev, route):
    """q and k as apply_rope leaves them (contiguous [B, H, S, D]), v as
    _split_heads makes it ([B, S, Hkv * D] viewed as [B, Hkv, S, D]: a
    sequence stride of Hkv * D); in decode, a layer's slice of a stacked
    cache."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.blocks import _split_heads

    g = torch.Generator(device=dev).manual_seed(11)
    sq = 150 if route == "tensor_core" else 1
    q = torch.randn(2, 32, sq, 128, generator=g, device=dev).to(torch.bfloat16)
    if route == "tensor_core":
        k = torch.randn(2, 8, sq, 128, generator=g, device=dev).to(torch.bfloat16)
        v = _split_heads(torch.randn(2, sq, 8 * 128, generator=g, device=dev).to(torch.bfloat16), 8)
        assert v.stride(2) == 8 * 128 and not v.is_contiguous()
        kw = dict(causal=True)
    else:
        cache = torch.randn(3, 2, 8, 576, 128, generator=g, device=dev).to(torch.bfloat16)
        k, v = cache[1], cache[2]
        kw = dict(causal=True, q_offset=99, kv_len=100)
    assert fa._aligned(v).data_ptr() == v.data_ptr()  # no copy
    got = _routed(fa, route, lambda: fa.flash_attention(q, k, v, **kw))
    _flash_close(got, fa.attention_plain(q, k.contiguous(), v.contiguous(), **kw), torch.bfloat16)


def test_tensor_core_route_copies_a_misaligned_view(dev):
    """Rows of 132 bf16 (264 bytes) cut to 128: TMA wants 16-byte strides,
    so the wrapper copies; a view 2 bytes past an aligned base too."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(12)
    wide = torch.randn(2, 8, 140, 132, generator=g, device=dev).to(torch.bfloat16)
    q = wide[..., 4:]
    flat = torch.randn(2 * 2 * 140 * 128 + 1, generator=g, device=dev).to(torch.bfloat16)
    k = flat[1:].view(2, 2, 140, 128)
    v = torch.randn(2, 2, 140, 128, generator=g, device=dev).to(torch.bfloat16)
    assert fa._aligned(q).data_ptr() != q.data_ptr() and fa._aligned(k).data_ptr() != k.data_ptr()
    got = _routed(fa, "tensor_core", lambda: fa.flash_attention(q, k, v))
    _flash_close(got, fa.attention_plain(q, k, v), torch.bfloat16)


def test_launch_route_runs_the_f32_kernel_on_bf16(dev):
    """The f32 route's kernel, named directly at the prefill shape's
    small cousin, agrees with the tensor-core route."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, 9, 2, 32, 8, 256, 256, 128, torch.bfloat16)
    a = _routed(fa, "f32", lambda: fa.launch_route("f32", q, k, v))
    b = _routed(fa, "tensor_core", lambda: fa.flash_attention(q, k, v))
    _flash_close(a, b, torch.bfloat16)


# -- flash attention's gradient: the backward kernels and the log-sum-exp ------------


def _rel_err(got, want):
    """max |got - want| over max |want|: phase 2's norm for gradients."""
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-30)


#: (b, hq, hkv, sq, sk, d, causal, softcap, q_offset, kv_len): chip_smoke.py phase 2's backward cases, cut in batch
_BWD_CASES = [
    (2, 32, 8, 576, 576, 128, True, 0.0, 0, None),  # the training step's shape, two sequences
    (2, 4, 4, 77, 77, 128, True, 0.0, 0, None),  # S not a tile multiple, G = 1
    (1, 32, 4, 130, 130, 64, True, 0.0, 0, None),  # G = 8, head_dim 64
    (2, 8, 2, 100, 160, 128, False, 0.0, 0, 120),  # kv_len < Sk, not causal
    (1, 8, 2, 64, 300, 128, True, 0.0, 200, 264),  # q_offset > 0, kv_len < Sk
    (1, 8, 8, 96, 96, 64, True, 30.0, 0, None),  # softcap
]


def _backward(fa, case, dtype, dev, route=None):
    """dQ, dK, dV of one case through the backward ``route`` (the
    Function's own choice when None), the launches of each backward
    kernel, and autograd's gradients through attention_plain."""
    b, hq, hkv, sq, sk, d, causal, cap, q_offset, kv_len = case
    kw = dict(causal=causal, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    q, k, v = _qkv(dev, sq + d, b, hq, hkv, sq, sk, d, dtype)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev).to(dtype)
    before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    if route is None:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = _routed(fa, fa._route(q, k, grad=True), lambda: fa.flash_attention(*leaves, **kw))
        got = torch.autograd.grad(out, leaves, dout)
    else:
        out, lse = fa.launch_route(fa._route(q, k, grad=True), q, k, v, with_lse=True, **kw)
        got = fa.launch_backward(q, k, v, out, lse, dout, route=route, **kw)
    launched = {n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()}
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*ref, **kw), ref, dout)
    return got, launched, want


def _launched_once(fa, route):
    return {f"{r}/{k}": int(r == route) for r, ks in fa.BWD_KERNELS.items() for k in ks}


def _check_grads(got, want, dtype, case):
    kv_len = case[-1]
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= _FLASH_TOL[dtype], (name, _rel_err(g, w))
    if kv_len is not None:  # keys past kv_len get no gradient
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", _BWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_backward_kernels_equal_autograd_of_plain(dev, case, dtype):
    """dQ, dK, dV through the Function (forward route with the
    log-sum-exp, then the backward route _bwd_route picks: tensor_core
    for bf16, cuda_core for f32 and f16) against autograd through
    attention_plain, each within test_kernels.py's tolerance of its max
    |value|; a second run gives the same bits (no atomics)."""
    from repro_torch.kernels import flash_attention as fa

    got, launched, want = _backward(fa, case, dtype, dev)
    route = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    assert launched == _launched_once(fa, route)
    _check_grads(got, want, dtype, case)
    again, _, _ = _backward(fa, case, dtype, dev)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("case", _BWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_cuda_core_backward_on_bf16(dev, case):
    """The CUDA-core kernels, named on the bf16 inputs the tensor-core
    route takes by default, within the same tolerance."""
    from repro_torch.kernels import flash_attention as fa

    got, launched, want = _backward(fa, case, torch.bfloat16, dev, route="cuda_core")
    assert launched == _launched_once(fa, "cuda_core")
    _check_grads(got, want, torch.bfloat16, case)


#: narrow heads on the f32 route and the cuda_core backward:
#: (b, hq, hkv, sq, sk, d, causal, softcap, q_offset, kv_len)
_NARROW_CASES = [
    (8, 4, 4, 64, 64, 16, True, 0.0, 0, None),  # launch.train's reduced config
    (2, 8, 2, 77, 77, 16, True, 0.0, 0, None),
    (2, 8, 2, 100, 160, 32, False, 0.0, 0, 120),
    (1, 8, 8, 96, 96, 32, True, 30.0, 0, None),
    (1, 8, 2, 64, 300, 32, True, 0.0, 200, 264),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("case", _NARROW_CASES, ids=lambda c: "x".join(map(str, c)))
def test_narrow_head_dims_forward_and_backward(dev, case, dtype):
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, d, causal, cap, q_offset, kv_len = case
    kw = dict(causal=causal, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    q, k, v = _qkv(dev, d + sq, b, hq, hkv, sq, sk, d, dtype)
    got = _routed(fa, "f32", lambda: fa.flash_attention(q, k, v, **kw))
    _flash_close(got, fa.attention_plain(q, k, v, **kw), dtype)
    got, launched, want = _backward(fa, case, dtype, dev)
    assert launched == _launched_once(fa, "cuda_core")
    _check_grads(got, want, dtype, case)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_f32_route_in_float16(dev, d):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, d, 2, 16, 4, 130, 130, d, torch.float16)
    got = _routed(fa, "f32", lambda: fa.flash_attention(q, k, v, softcap=20.0))
    assert got.dtype == torch.float16
    _flash_close(got, fa.attention_plain(q, k, v, softcap=20.0), torch.float16)


# -- the CUDA-core kernels' tiling: GQA packing, ragged edges, dead cache slots ------

#: (b, hq, hkv, sq, sk, causal, q_offset, kv_len): groups of 7 (yi-34b's
#: 56/8 heads) and 64 (MAX_GROUP), Sq and Sk off every tile edge, decode-
#: sized calls; with kv_len < Sk the slots past it hold NaN in K and V
_TILE_CASES = [
    (1, 56, 8, 129, 129, True, 0, None),  # G 7
    (1, 64, 1, 65, 65, True, 0, None),  # G 64: one position a sub-tile
    (2, 8, 2, 1, 577, True, 500, 501),  # a decode step on a cache of 577, NaN past 501
    (1, 8, 2, 63, 127, False, 0, 100),  # not causal, NaN past 100
    (1, 4, 4, 577, 577, True, 0, None),  # G 1, Sq = Sk = 577
    (1, 28, 4, 127, 200, True, 60, 187),  # G 7, q_offset, NaN past 187
]


def _tile_inputs(dev, case, d, dtype):
    """q, k, v with NaN in the dead slots, the same with zeros there (what
    the plain versions see: 0 x NaN is NaN in any product), and the kw."""
    b, hq, hkv, sq, sk, causal, q_offset, kv_len = case
    q, k, v = _qkv(dev, hq + sq + d, b, hq, hkv, sq, sk, d, dtype)
    kz, vz = k.clone(), v.clone()
    if kv_len is not None:
        k[:, :, kv_len:] = float("nan")
        v[:, :, kv_len:] = float("nan")
        kz[:, :, kv_len:] = 0
        vz[:, :, kv_len:] = 0
    return (q, k, v), (q, kz, vz), dict(causal=causal, q_offset=q_offset, kv_len=kv_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("case", _TILE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_f32_route_tiling(dev, case, d, dtype):
    """The f32 route's kernel, named, at every head_dim and dtype it takes,
    against the plain version (with the dead slots zeroed), and its
    log-sum-exp against logsumexp of the plain scores."""
    from repro_torch.kernels import flash_attention as fa

    (q, k, v), (q, kz, vz), kw = _tile_inputs(dev, case, d, dtype)
    out, lse = _routed(fa, "f32", lambda: fa.launch_route("f32", q, k, v, with_lse=True, **kw))
    assert torch.isfinite(out).all()
    _flash_close(out, fa.attention_plain(q, kz, vz, **kw), dtype)
    torch.testing.assert_close(lse, fa.attention_lse_plain(q, kz, **kw), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("case", _TILE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_cuda_core_backward_tiling(dev, case, d, dtype):
    """The cuda_core backward's three kernels, named, at every head_dim and
    dtype it takes, against autograd through the plain attention (dead
    slots zeroed): finite, within test_kernels.py's tolerance of each
    gradient's max |value|, zeros past kv_len, and the same bits on a rerun."""
    from repro_torch.kernels import flash_attention as fa

    (q, k, v), (q, kz, vz), kw = _tile_inputs(dev, case, d, dtype)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(d), device=dev).to(dtype)
    out, lse = fa.launch_route("f32", q, k, v, with_lse=True, **kw)
    before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    got = fa.launch_backward(q, k, v, out, lse, dout, route="cuda_core", **kw)
    assert {n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()} == _launched_once(fa, "cuda_core")
    again = fa.launch_backward(q, k, v, out, lse, dout, route="cuda_core", **kw)
    ref = [t.clone().requires_grad_() for t in (q, kz, vz)]
    want = torch.autograd.grad(fa.attention_plain(*ref, **kw), ref, dout)
    _check_grads(got, want, dtype, (kw["kv_len"],))
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("route,dtype", [("tensor_core", torch.bfloat16), ("f32", torch.float32),
                                         ("f32", torch.bfloat16)])
@pytest.mark.parametrize("case", [(2, 32, 8, 576, 576, 128, True, 0.0, 0, None), (1, 8, 2, 77, 300, 64, True, 0.0, 200, 277),
                                  (1, 8, 8, 96, 96, 128, False, 30.0, 0, 80)], ids=lambda c: "x".join(map(str, c)))
def test_forward_writes_the_log_sum_exp(dev, route, dtype, case):
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, d, causal, cap, q_offset, kv_len = case
    kw = dict(causal=causal, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    q, k, v = _qkv(dev, 5, b, hq, hkv, sq, sk, d, dtype)
    out, lse = fa.launch_route(route, q, k, v, with_lse=True, **kw)
    _flash_close(out, fa.launch_route(route, q, k, v, **kw), dtype)  # the serving call: the same output
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, fa.attention_lse_plain(q, k, **kw), rtol=2e-5, atol=2e-5)


def test_gradient_never_takes_the_decode_route(dev):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, 2, 2, 32, 8, 1, 64, 128, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = _routed(fa, "tensor_core", lambda: fa.flash_attention(*leaves, q_offset=63))
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="gemma2"):
        q256, k256, v256 = (t.requires_grad_() for t in _qkv(dev, 3, 1, 2, 2, 80, 80, 256, torch.bfloat16))
        fa.flash_attention(q256, k256, v256)


def test_grpo_step_gradients_on_the_card(dev):
    """A small GQA decoder (head_dim 64, f32) on the card: the GRPO loss's
    gradients through the flash kernels and the backward kernels against
    the same loss through attention_plain, every tensor within 1e-4 of its
    max |value| (cuBLAS sums in other orders on the two paths)."""
    import dataclasses

    from repro_torch.configs.llama3_8b import CONFIG
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.lm import DecoderLM
    from repro_torch.models.params import init_params
    from repro_torch.training.steps import make_grpo_loss_fn, value_and_grad

    cfg = dataclasses.replace(CONFIG, num_layers=2, d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024, vocab=1024)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 90), device=dev, generator=g)
    batch = {"tokens": tokens, "behavior_logprobs": -7 + torch.rand((4, 89), device=dev, generator=g),
             "advantages": torch.randn(4, device=dev, generator=g),
             "loss_mask": torch.arange(89, device=dev)[None, :].expand(4, 89) >= 60}
    before = fa.BWD_LAUNCHES["cuda_core/dq"].value
    got, m1 = value_and_grad(make_grpo_loss_fn(DecoderLM(cfg)), params, batch)
    assert fa.BWD_LAUNCHES["cuda_core/dq"].value - before == cfg.num_layers
    want, m2 = value_and_grad(make_grpo_loss_fn(DecoderLM(cfg, attention=fa.attention_plain)), params, batch)
    torch.testing.assert_close(m1["loss"], m2["loss"], rtol=1e-4, atol=1e-6)
    for n in want:
        assert float(got[n].abs().max()) > 0, n
        assert _rel_err(got[n], want[n]) <= 1e-4, (n, _rel_err(got[n], want[n]))


@pytest.mark.parametrize("name", ["uint16", "uint32", "uint64", "float8_e4m3fn", "float8_e5m2", "complex64"])
def test_wire_dtypes_replicate_on_the_card(dev, name):
    """Each of the six wire dtypes beyond a model's float and int types,
    published and replicated raw (dc0) and over int8 (dc1, a passthrough
    frame) on the card, bit for bit."""
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.core.meta import dtype_from_str

    dt = dtype_from_str(name)
    g = torch.Generator(device=dev).manual_seed(len(name))
    w = {"w": torch.randint(0, 256, (1024 * dt.itemsize,), dtype=torch.uint8, generator=g, device=dev).view(dt)}
    hub = TensorHubClient(ReferenceServer(), device=dev)
    trainer = hub.open("m", "trainer", 1, 0, datacenter="dc0")
    trainer.register({k: t.clone() for k, t in w.items()})
    trainer.publish(0)
    for i in range(2):
        r = hub.open("m", f"rollout-{i}", 1, 0, datacenter=f"dc{i}")
        r.register({k: torch.zeros_like(t) for k, t in w.items()})
        assert r.replicate(0, timeout=60) == 0
        got = r.store.get("w")
        assert got.dtype == dt and got.device == w["w"].device
        assert torch.equal(got.view(torch.uint8), w["w"].view(torch.uint8))


def test_train_entry_point_at_its_defaults(dev):
    """python -m repro_torch.launch.train at its defaults (the reduced
    config: head_dim 16, f32, on the card) for two steps: the f32 route's
    forward and the cuda_core backward run every layer."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train

    before = fa.ROUTE_LAUNCHES["f32"].value, fa.BWD_LAUNCHES["cuda_core/dkdv"].value
    train.main(["--steps", "2"])
    assert fa.ROUTE_LAUNCHES["f32"].value - before[0] == 2 * 4
    assert fa.BWD_LAUNCHES["cuda_core/dkdv"].value - before[1] == 2 * 4


# -- the socketed data plane on the card ------------------------------------------


def _socket_pull(device, codec):
    """A ``WorkerDataServer`` serving a store on ``device`` over a
    localhost socket to a ``RemoteTransport`` pulling into a store on
    ``device``: every unit, raw (verified against the manifest), int8,
    delta:int8 (v1 against an int8-held v0) or as int8 wire frames
    (``raw_wire``); returns the destination's bytes (the frames, for
    ``raw_wire``) on the host and the transport."""
    from repro_torch.net.data import RemoteTransport, WorkerDataServer
    from repro_torch.transfer.engine import WorkerRegistry, WorkerStore

    g = torch.Generator().manual_seed(3)
    w = {"w": (torch.randn(3 << 20, generator=g) * 0.02).to(torch.bfloat16),
         "f": torch.randn(70_000, generator=g), "b": torch.randn(1000, generator=g)}
    w1 = {k: v.clone() for k, v in w.items()}
    for t in w1.values():  # v1, made on the host: 1/8 of the 256-element rows
        flat = t.view(-1)
        flat[: flat.numel() // 256 * 256].view(-1, 256)[::8] += 0.01
    src = WorkerStore("src", device=device)
    src.register({k: v.to(device) for k, v in w.items()})
    reg = WorkerRegistry()
    reg.add("src", 0, src)
    server = WorkerDataServer(reg, device=device).start()
    dst = WorkerStore("dst", device=device)
    dst.register({k: torch.zeros_like(v, device=device) for k, v in w.items()})
    tr = RemoteTransport(WorkerRegistry(), lambda *_: server.address, device=device)
    try:
        if codec == "raw_wire":
            return b"".join(
                tr.read_unit_range("src", 0, u, 0, u.nbytes, codec="int8", decode=False).cpu().numpy().tobytes()
                for u in src.units
            ), tr
        sums = src.build_manifest().checksums
        if codec == "delta:int8":
            for u in src.units:  # dst holds v0 as an int8 replica does
                tr.pull_unit("src", 0, u, sums[u.index], dst, codec="int8")
            src.snapshot_base(0)
            for k, t in src.tensors().items():
                t.copy_(w1[k].to(device))
            sums = src.build_manifest().checksums
        for u in src.units:
            tr.pull_unit("src", 0, u, sums[u.index], dst, codec=codec)
        return b"".join(t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
                        for t in dst.tensors().values()), tr
    finally:
        tr.close_pool()
        server.shutdown()


@pytest.mark.parametrize("codec", ["raw", "int8", "delta:int8", "raw_wire"])
def test_socket_pull_on_the_card_equals_cpu(dev, codec):
    """The networked data plane with both stores on the card moves the
    same bytes as between CPU stores, through the checksum kernel (and
    the quant kernel for the codecs) at both ends of the socket."""
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import quant as qk

    before = ck.LAUNCHES.value, qk.LAUNCHES.value
    got, tr = _socket_pull(dev, codec)
    assert ck.LAUNCHES.value > before[0]
    assert (qk.LAUNCHES.value > before[1]) == (codec != "raw")
    want, tr_cpu = _socket_pull(torch.device("cpu"), codec)
    assert got == want
    assert tr.wire_bytes == tr_cpu.wire_bytes and tr.delta_stale_fallbacks == 0
    assert tr.conn_opens >= 1
