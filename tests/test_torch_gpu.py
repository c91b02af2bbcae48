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

    q, k, v = _qkv(dev, 0, 1, 4, 2, 8, 8, 96, torch.float32)  # no route has head_dim 96
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


@pytest.mark.parametrize("d", [64, 128, 80])
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
    """Named: flash_attention sends bf16 at head_dim 256 to tensor_core."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, 5, 1, 4, 2, 200, 200, 256, torch.bfloat16)
    assert fa._route(q, k) == "tensor_core"
    got = _routed(fa, "f32", lambda: fa.launch_route("f32", q, k, v))
    _flash_close(got, fa.attention_plain(q, k, v), torch.bfloat16)


#: the tensor-core forward at head_dim 256 (gemma2: 8/4 heads, softcap 50,
#: window 4096): (b, hq, hkv, sq, sk, causal, q_offset, kv_len, window,
#: softcap); with kv_len < Sk the slots past it hold NaN in K and V
_TC256_CASES = [
    (2, 8, 4, 300, 300, True, 0, None, 0, 50.0),  # G 2, unwindowed, softcap
    (1, 8, 4, 600, 600, True, 0, None, 8, 50.0),  # a window inside one tile
    (1, 8, 4, 400, 400, True, 0, None, 64, 0.0),
    (1, 8, 4, 700, 700, True, 0, None, 100, 50.0),  # across tiles
    (1, 8, 4, 4200, 4200, True, 0, None, 4096, 50.0),  # gemma2's window, biting past 4096
    (1, 56, 8, 129, 400, True, 200, 329, 64, 0.0),  # G 7, q_offset, NaN past kv_len
    (2, 8, 4, 130, 500, False, 0, 450, 0, 0.0),  # not causal, NaN past kv_len
    (1, 8, 4, 77, 300, True, 200, 277, 100, 50.0),  # an offset chunk
]


@pytest.mark.parametrize("case", _TC256_CASES, ids=lambda c: "x".join(map(str, c)))
def test_tensor_core_forward_at_head_dim_256(dev, case):
    """gemma2's prefill route: the tensor-core forward at head_dim 256,
    with and without the log-sum-exp, against the plain version with the
    dead slots zeroed."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, causal, q_offset, kv_len, window, cap = case
    q, k, v = _qkv(dev, sq + window, b, hq, hkv, sq, sk, 256, torch.bfloat16)
    kz, vz = k.clone(), v.clone()
    if kv_len is not None:
        k[:, :, kv_len:] = float("nan")
        v[:, :, kv_len:] = float("nan")
        kz[:, :, kv_len:] = 0
        vz[:, :, kv_len:] = 0
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window, softcap=cap)
    if sq * hq // hkv > fa.DECODE_ROWS:
        assert fa._route(q, k) == "tensor_core"
    got = _routed(fa, "tensor_core", lambda: fa.launch_route("tensor_core", q, k, v, **kw))
    assert torch.isfinite(got).all()
    _flash_close(got, fa.attention_plain(q, kz, vz, **kw), torch.bfloat16)
    out, lse = fa.launch_route("tensor_core", q, k, v, with_lse=True, **kw)
    assert torch.equal(out, got)
    torch.testing.assert_close(lse, fa.attention_lse_plain(q, kz, **kw), rtol=2e-5, atol=2e-5)


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
    (2, 8, 4, 300, 300, 256, True, 50.0, 0, None),  # head_dim 256 (gemma2: G 2, softcap 50)
    (1, 8, 2, 64, 300, 256, True, 0.0, 200, 264),  # head_dim 256, q_offset > 0, kv_len < Sk
    (2, 16, 8, 512, 512, 128, True, 0.0, 0, None),  # internvl2-2b's f32 step (phase 14): G 2
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


def _launched_once(fa, route, d):
    """One launch of each kernel a call on ``route`` at head_dim ``d``
    launches (at 256, ``pre`` and the one ``dkdv_dq``), none of the rest."""
    return {f"{r}/{k}": int(r == route and k in fa.bwd_kernels(d)) for r, ks in fa.BWD_KERNELS.items()
            for k in ks}


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
    assert launched == _launched_once(fa, route, case[5])
    _check_grads(got, want, dtype, case)
    again, _, _ = _backward(fa, case, dtype, dev)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("case", _BWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_cuda_core_backward_on_bf16(dev, case):
    """The CUDA-core kernels, named on the bf16 inputs the tensor-core
    route takes by default, within the same tolerance."""
    from repro_torch.kernels import flash_attention as fa

    got, launched, want = _backward(fa, case, torch.bfloat16, dev, route="cuda_core")
    assert launched == _launched_once(fa, "cuda_core", case[5])
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
    assert launched == _launched_once(fa, "cuda_core", d)
    _check_grads(got, want, dtype, case)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 80])
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
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 80])
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
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 80])
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
    assert {n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()} == _launched_once(fa, "cuda_core", d)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(1, 32, 32, 256, 80, False, 0.0, 0, None, 0), (1, 32, 32, 4096, 80, False, 0.0, 0, 3000, 0),
                                  (4, 32, 8, 576, 128, True, 0.0, 575, None, 0), (2, 8, 4, 700, 64, True, 30.0, 650, 690, 0),
                                  (2, 16, 8, 300, 256, True, 0.0, 299, 300, 128), (3, 8, 8, 64, 80, False, 0.0, 0, 5, 0)],
                         ids=lambda c: "x".join(map(str, c)))
def test_decode_route_writes_the_log_sum_exp(dev, dtype, case):
    """The decode route with its lse: the output bit-equal to the same
    call's without it, within the route's tolerance of the plain version,
    and the lse within 2e-5 of ``attention_lse_plain`` (split plans of one
    and of many splits, GQA, a softcap, a window, kv_len < Sk)."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sk, d, causal, cap, q_offset, kv_len, window = case
    q, k, v = _qkv(dev, 9 + sk, b, hq, hkv, 1, sk, d, dtype)
    kw = dict(causal=causal, softcap=cap, q_offset=q_offset, kv_len=kv_len, window=window)
    assert fa._route(q, k) == "decode"
    out, lse = fa.launch_route("decode", q, k, v, with_lse=True, **kw)
    assert torch.equal(out, fa.launch_route("decode", q, k, v, **kw))
    _flash_close(out, fa.attention_plain(q, k, v, **kw), dtype)
    assert lse.shape == (b, hq, 1) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, fa.attention_lse_plain(q, k, **kw), rtol=2e-5, atol=2e-5)
    got, got_lse = fa.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(got, out) and torch.equal(got_lse, lse)


@pytest.mark.parametrize("blocks", [1, 2, 16])
def test_ring_blocks_merged_on_the_card_equal_the_whole_ring(dev, blocks):
    """zamba2's ring (q [1,32,1,80] f32, 4096 slots, ``causal=False``) in
    ``blocks`` blocks through the decode kernel with the lse, merged by
    ``merge_attention``: within 2e-5 of the one call over the whole ring and
    of the plain version; one block is the call itself, bit for bit."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, 31, 1, 32, 32, 1, 4096, 80, torch.float32)
    n = 4096 // blocks
    parts = [fa.launch_route("decode", q, k[:, :, i * n:(i + 1) * n], v[:, :, i * n:(i + 1) * n], causal=False,
                             with_lse=True) for i in range(blocks)]
    out, lse = fa.merge_attention(torch.stack([o for o, _ in parts]), torch.stack([s for _, s in parts]))
    whole, whole_lse = fa.launch_route("decode", q, k, v, causal=False, with_lse=True)
    if blocks == 1:
        assert torch.equal(out, whole) and torch.equal(lse, whole_lse)
    for want, want_lse in ((whole, whole_lse), (fa.attention_plain(q, k, v, causal=False),
                                                 fa.attention_lse_plain(q, k, causal=False))):
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)


def test_gradient_never_takes_the_decode_route(dev):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(dev, 2, 2, 32, 8, 1, 64, 128, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = _routed(fa, "tensor_core", lambda: fa.flash_attention(*leaves, q_offset=63))
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="head_dim 96"):  # no backward kernel takes it
        q96, k96, v96 = (t.requires_grad_() for t in _qkv(dev, 3, 1, 2, 2, 80, 80, 96, torch.bfloat16))
        fa.flash_attention(q96, k96, v96)


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


# -- the sliding window (gemma2's local layers) on every route ------------------------

#: (b, hq, hkv, sq, sk, d, causal, q_offset, kv_len, window, softcap); with
#: kv_len < Sk the slots past it hold NaN in K and V
_WINDOW_CASES = [
    (2, 8, 4, 300, 300, 128, True, 0, None, 8, 0.0),  # a window inside one tile
    (2, 8, 4, 300, 300, 256, True, 0, None, 8, 0.0),  # head_dim 256 (f32 and decode routes)
    (2, 8, 4, 400, 400, 64, True, 0, None, 100, 50.0),  # across tiles, softcap
    (1, 8, 4, 600, 600, 128, True, 0, None, 4096, 0.0),  # wider than the keys
    (1, 8, 4, 64, 800, 128, True, 600, 664, 100, 0.0),  # an offset chunk, NaN past kv_len
    (2, 8, 4, 1, 900, 256, True, 799, 800, 100, 50.0),  # a decode step
    (2, 8, 4, 4, 800, 128, True, 700, 704, 8, 0.0),  # a decode chunk
    (1, 56, 8, 129, 400, 128, True, 200, 329, 64, 0.0),  # G 7
    (1, 8, 4, 200, 300, 64, False, 0, 250, 64, 0.0),  # not causal
    (1, 8, 4, 1, 70, 64, True, 69, 70, 1, 0.0),  # window 1: each query its own key
]
_WINDOW_IDS = ["x".join(map(str, c)) for c in _WINDOW_CASES]


def _window_inputs(dev, case, dtype):
    b, hq, hkv, sq, sk, d, causal, q_offset, kv_len, window, cap = case
    q, k, v = _qkv(dev, sq + d + window, b, hq, hkv, sq, sk, d, dtype)
    kz, vz = k.clone(), v.clone()
    if kv_len is not None:
        k[:, :, kv_len:] = float("nan")
        v[:, :, kv_len:] = float("nan")
        kz[:, :, kv_len:] = 0
        vz[:, :, kv_len:] = 0
    return (q, k, v), (kz, vz), dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window, softcap=cap)


def _window_routes(fa, q, k, dtype):
    sq, g, d = q.shape[2], q.shape[1] // k.shape[1], q.shape[3]
    out = ["f32"]
    if dtype == torch.bfloat16 and d in fa.TC_HEAD_DIMS:
        out.append("tensor_core")
    if sq * g <= fa.DECODE_ROWS and d in fa.HEAD_DIMS:
        out.append("decode")
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _WINDOW_CASES, ids=_WINDOW_IDS)
def test_windowed_routes_equal_plain(dev, case, dtype):
    """Every forward route that takes the call, named, with a window,
    against the plain version (dead slots zeroed); the f32 and
    tensor_core routes' log-sum-exp too."""
    from repro_torch.kernels import flash_attention as fa

    (q, k, v), (kz, vz), kw = _window_inputs(dev, case, dtype)
    want = fa.attention_plain(q, kz, vz, **kw)
    for route in _window_routes(fa, q, k, dtype):
        got = _routed(fa, route, lambda: fa.launch_route(route, q, k, v, **kw))
        assert torch.isfinite(got).all(), route
        _flash_close(got, want, dtype)
        if route != "decode":
            _, lse = fa.launch_route(route, q, k, v, with_lse=True, **kw)
            torch.testing.assert_close(lse, fa.attention_lse_plain(q, kz, **kw), rtol=2e-5, atol=2e-5)


_BWD_WINDOW_CASES = [c for c in _WINDOW_CASES if c[9] > 1]
_BWD_WINDOW_IDS = [i for c, i in zip(_WINDOW_CASES, _WINDOW_IDS) if c[9] > 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", _BWD_WINDOW_CASES, ids=_BWD_WINDOW_IDS)
def test_windowed_cuda_core_backward(dev, case, dtype):
    """The cuda_core backward's three kernels with a window, against
    autograd through the plain attention, and bit-equal on a rerun (not
    at window 1, where a row's softmax is one key and dQ, dK vanish)."""
    from repro_torch.kernels import flash_attention as fa

    (q, k, v), (kz, vz), kw = _window_inputs(dev, case, dtype)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev).to(dtype)
    out, lse = fa.launch_route("f32", q, k, v, with_lse=True, **kw)
    got = fa.launch_backward(q, k, v, out, lse, dout, route="cuda_core", **kw)
    again = fa.launch_backward(q, k, v, out, lse, dout, route="cuda_core", **kw)
    ref = [t.clone().requires_grad_() for t in (q, kz, vz)]
    want = torch.autograd.grad(fa.attention_plain(*ref, **kw), ref, dout)
    _check_grads(got, want, dtype, (kw["kv_len"],))
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("d", [64, 128, 256, 80])
@pytest.mark.parametrize("case", _BWD_WINDOW_CASES, ids=_BWD_WINDOW_IDS)
def test_windowed_tensor_core_backward(dev, case, d):
    """The tensor_core backward's three kernels with a window, at each
    head_dim they take, through the Function (forward on tensor_core),
    against autograd through the plain attention, and bit-equal on a
    rerun."""
    from repro_torch.kernels import flash_attention as fa

    case = case[:5] + (d,) + case[6:]
    (q, k, v), (kz, vz), kw = _window_inputs(dev, case, torch.bfloat16)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(4), device=dev).to(torch.bfloat16)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
        out = _routed(fa, "tensor_core", lambda: fa.flash_attention(*leaves, **kw))
        got = torch.autograd.grad(out, leaves, dout)
        assert {n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()} == _launched_once(fa, "tensor_core", d)
        return got

    got = grads()
    again = grads()
    ref = [t.clone().requires_grad_() for t in (q, kz, vz)]
    want = torch.autograd.grad(fa.attention_plain(*ref, **kw), ref, dout)
    _check_grads(got, want, torch.bfloat16, (kw["kv_len"],))
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_gemma2_serves_across_the_window_on_the_card(dev):
    """A small gemma2 (window 8, softcaps, tied, head_dim 256 as
    published) in bf16 on the card: prefill on the tensor_core route, decode on
    the decode route, against a forward with the plain attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config("gemma2-2b"), num_layers=4, d_model=512, d_ff=1024, vocab=1024,
                              sliding_window=8)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    model, ref = build_model(cfg), build_model(cfg, attention=fa.attention_plain)
    toks = torch.randint(0, cfg.vocab, (2, 60), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    before = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
    logits, cache, n = model.prefill(params, {"tokens": toks[:, :40]}, max_len=60)  # 80 packed rows: tensor_core
    steps = [logits[:, -1]]
    for t in range(40, 59):
        logits, cache = model.decode(params, cache, toks[:, t : t + 1], n)
        n += 1
        steps.append(logits[:, -1])
    launched = {r: c.value - before[r] for r, c in fa.ROUTE_LAUNCHES.items()}
    assert launched == {"f32": 0, "decode": 4 * 19, "tensor_core": 4}
    want = ref.forward(params, {"tokens": toks})[:, 39:59]
    got = torch.stack(steps, 1)
    assert torch.isfinite(got).all() and float((got - want).abs().max()) < 0.5


def test_train_entry_point_on_the_reduced_gemma2(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train

    before = fa.ROUTE_LAUNCHES["f32"].value, fa.BWD_LAUNCHES["cuda_core/dkdv"].value
    train.main(["--arch", "gemma2-2b", "--steps", "2"])
    assert fa.ROUTE_LAUNCHES["f32"].value - before[0] == 2 * 4
    assert fa.BWD_LAUNCHES["cuda_core/dkdv"].value - before[1] == 2 * 4


# -- routed experts (dbrx-132b): GQA 6 on every route it takes, tensors past 2^31 elements ----------


#: dbrx's attention at chip_smoke.py phase 11's shapes (48 query and 8 KV
#: heads of 128): the served prefill, its last decode step (528 keys) and
#: the GRPO step's 4 x 576
_DBRX_FORWARD = {"tensor_core": (4, 48, 8, 512, 512, dict(causal=True)),
                 "decode": (4, 48, 8, 1, 528, dict(causal=True, q_offset=527, kv_len=528))}


@pytest.mark.parametrize("route", list(_DBRX_FORWARD))
def test_dbrx_group_of_6_on_its_forward_routes(dev, route):
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, kw = _DBRX_FORWARD[route]
    q, k, v = _qkv(dev, sq, b, hq, hkv, sq, sk, 128, torch.bfloat16)
    assert fa._route(q, k) == route
    before = fa.ROUTE_LAUNCHES[route].value
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.ROUTE_LAUNCHES[route].value == before + 1
    _flash_close(got, fa.attention_plain(q, k, v, **kw), torch.bfloat16)


#: the head_dim-256 backwards (one launch of dK/dV and dQ after pre):
#: (b, hq, hkv, sq, sk, causal, softcap, q_offset, kv_len, window); phase
#: 10's and phase 7's launch shapes, 4672 rows, and the edges
_BWD256_CASES = [
    (4, 8, 4, 576, 576, True, 50.0, 0, None, 4096),  # phase 10's launch shape
    (2, 8, 4, 512, 512, True, 50.0, 0, None, 4096),  # phase 7's
    (2, 8, 4, 4672, 4672, True, 50.0, 0, None, 4096),  # gemma2's 4608 + 64, the window biting
    (1, 4, 4, 77, 77, True, 50.0, 0, None, 0),  # G 1, Sq 77
    (1, 8, 4, 300, 300, True, 0.0, 0, None, 0),  # G 2, Sq 300
    (1, 16, 4, 130, 130, True, 30.0, 0, None, 0),  # G 4
    (1, 32, 4, 100, 100, True, 0.0, 0, None, 8),  # G 8, window 8
    (1, 56, 8, 129, 129, True, 0.0, 0, None, 0),  # G 7
    (2, 8, 2, 100, 160, False, 0.0, 0, 120, 0),  # kv_len < Sk, not causal
    (1, 8, 2, 64, 300, True, 0.0, 200, 264, 0),  # q_offset > 0, kv_len < Sk
    (1, 8, 4, 300, 300, True, 50.0, 0, None, 64),  # window 64
    (1, 8, 4, 200, 300, False, 0.0, 0, 250, 64),  # window 64, not causal, kv_len < Sk
    (1, 8, 4, 77, 400, True, 50.0, 223, 300, 100),  # q_offset, window, kv_len < Sk
]
#: (route, dtype) pairs the head_dim-256 backward takes: the training
#: step's bf16 on tensor_core, launch.train's f32 on cuda_core (and f16,
#: and bf16 when named)
_BWD256_ROUTES = [("tensor_core", torch.bfloat16), ("cuda_core", torch.float32), ("cuda_core", torch.float16),
                  ("cuda_core", torch.bfloat16)]
#: every case on every pair, but 4672 rows only on each route's own type
_BWD256_PARAMS = [(c, r, t) for c in _BWD256_CASES for r, t in _BWD256_ROUTES if c[3] <= 1024 or r == "tensor_core"
                  or t == torch.float32]


def _dead_keys(case):
    """The keys no query row sees: past kv_len, before every row's window,
    after every row's causal edge."""
    b, hq, hkv, sq, sk, causal, cap, q_offset, kv_len, window = case
    kv_len = sk if kv_len is None else kv_len
    keys = torch.arange(sk)[None, :]
    pos = q_offset + torch.arange(sq)[:, None]
    live = keys < kv_len
    if causal:
        live = live & (keys <= pos)
    if window > 0:
        live = live & (keys > pos - window)
    return ~live.any(0)


@pytest.mark.parametrize("case,route,dtype", _BWD256_PARAMS,
                         ids=["x".join(map(str, c)) + f"-{r}-{str(t).split('.')[-1]}" for c, r, t in _BWD256_PARAMS])
def test_bwd256_one_launch_equals_plain_backward(dev, case, route, dtype):
    """The head_dim-256 backward of each route (pre, then the one dkdv_dq
    launch) on the forward's own output and lse, against
    attention_backward_plain on the same inputs, within FLASH_TOL of each
    gradient's max |value|; NaN in K/V past kv_len never read; exactly zero
    dK and dV for the keys no row sees; the same bits on a rerun."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, causal, cap, q_offset, kv_len, window = case
    kw = dict(causal=causal, softcap=cap, q_offset=q_offset, kv_len=kv_len, window=window)
    q, k, v = _qkv(dev, sq + hq + window, b, hq, hkv, sq, sk, 256, dtype)
    kz, vz = k.clone(), v.clone()
    if kv_len is not None:
        k[:, :, kv_len:] = float("nan")
        v[:, :, kv_len:] = float("nan")
        kz[:, :, kv_len:] = 0
        vz[:, :, kv_len:] = 0
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(sq), device=dev).to(dtype)
    fwd = "tensor_core" if route == "tensor_core" else "f32"
    out, lse = fa.launch_route(fwd, q, k, v, with_lse=True, **kw)
    before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    got = fa.launch_backward(q, k, v, out, lse, dout, route=route, **kw)
    assert {n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()} == _launched_once(fa, route, 256)
    again = fa.launch_backward(q, k, v, out, lse, dout, route=route, **kw)
    want = fa.attention_backward_plain(q, kz, vz, out, lse, dout, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= _FLASH_TOL[dtype], (name, _rel_err(g, w))
    dead = _dead_keys(case).to(dev)
    assert not got[1][:, :, dead].any() and not got[2][:, :, dead].any()
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_bwd256_work_list_on_the_card(dev):
    """The work list a call hands the kernel: made once a shape (cached on
    the device), laid out as the kernel reads it (offsets, then four ints
    an item), one block an SM at most."""
    from repro_torch.kernels import flash_attention as fa

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kw = dict(causal=True, q_offset=0, kv_len=576, window=4096)
    work, grid = fa._bwd256_work("tensor_core", dev, 4, 8, 4, 576, 576, **kw)
    assert fa._bwd256_work("tensor_core", dev, 4, 8, 4, 576, 576, **kw)[0] is work
    blocks = fa.bwd256_order("tensor_core", 4, 8, 4, 576, 576, sms=sms, **kw)
    flat = work.cpu().tolist()
    assert grid == len(blocks) == min(sms, sum(map(len, blocks))) and flat[: grid + 1][-1] == sum(map(len, blocks))
    items = [tuple(flat[grid + 1 + 4 * u : grid + 5 + 4 * u]) for u in range(flat[grid])]
    assert items == [it[:4] for blk in blocks for it in blk]


def test_dbrx_group_of_6_on_the_tensor_core_backward(dev):
    from repro_torch.kernels import flash_attention as fa

    case = (4, 48, 8, 576, 576, 128, True, 0.0, 0, None)
    got, launched, want = _backward(fa, case, torch.bfloat16, dev)
    assert launched == _launched_once(fa, "tensor_core", 128)
    _check_grads(got, want, torch.bfloat16, case)
    again, _, _ = _backward(fa, case, torch.bfloat16, dev)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_checksum_and_quantize_past_2_31_elements(dev):
    """A bf16 tensor of 2^31 + 2^20 elements (4.3 GB): the checksum of the
    whole against the plain version's sums over 256 MiB pieces (each starts
    at a multiple of 2^16 words, so its weights are the whole's), and of its
    last 64 MiB, a view past 2^32 bytes; the int8 rows and scales of its
    last 2^26 elements against the plain version of the same view."""
    n = (1 << 31) + (1 << 20)
    x = torch.empty(n, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for i in range(0, n, 1 << 28):
        x[i : i + (1 << 28)].normal_(generator=g)
    raw = x.view(torch.uint8)
    got = ck.checksum_words(raw).to(torch.int64) & 0xFFFFFFFF
    want = torch.zeros(2, dtype=torch.int64, device=dev)
    for i in range(0, raw.numel(), 256 << 20):
        want = (want + ck.checksum_words_plain(raw[i : i + (256 << 20)])) & 0xFFFFFFFF
    assert torch.equal(got, want)
    tail = raw[-(64 << 20):]
    assert torch.equal(ck.checksum_words(tail).to(torch.int64) & 0xFFFFFFFF, ck.checksum_words_plain(tail))
    q, s = qk.quantize_rows(x)
    assert q.numel() == n and s.numel() == n // 256
    last = 1 << 26
    q2, s2 = qk.quantize_rows_plain(x[-last:])
    assert torch.equal(q[-last:], q2) and torch.equal(s[-last // 256:].view(torch.int32), s2.view(torch.int32))


def test_moe_decoder_serves_on_the_card(dev, monkeypatch):
    """A narrow dbrx (4 layers, 12/2 heads of 64: G = 6, 16 experts top-4)
    in bf16: the prefill on the tensor-core route and the decode steps on
    the decode route, each step's logits within phase 5's bounds of the
    same calls replayed with the plain attention, the replay following the
    served experts (at random weights near-tied router logits let the last
    bits pick a token's experts); every call's routed pairs counted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import blocks, build_model
    from repro_torch.models.params import init_params

    cfg = get_config("dbrx-132b")
    cfg = dataclasses.replace(cfg, num_layers=4, d_model=768, num_heads=12, num_kv_heads=2, vocab=1024,
                              moe=dataclasses.replace(cfg.moe, d_expert=512))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    toks = torch.randint(0, cfg.vocab, (4, 72), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    route, calls, pins = blocks.route, [], []

    def recording(cfg, p, flat, experts=None):
        top_p, top_e = route(cfg, p, flat, pins[len(calls)] if pins else None)
        calls.append(top_e)
        return top_p, top_e

    monkeypatch.setattr(blocks, "route", recording)

    def run(model):
        logits, cache, n = model.prefill(params, {"tokens": toks[:, :64]}, max_len=72)
        steps = [logits[:, -1]]
        for t in range(64, 71):
            logits, cache = model.decode(params, cache, toks[:, t : t + 1], n)
            n += 1
            steps.append(logits[:, -1])
        return torch.stack(steps, 1)

    before = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
    blocks.DROPPED.reset()
    got = run(build_model(cfg))
    assert {r: c.value - before[r] for r, c in fa.ROUTE_LAUNCHES.items()} == {"f32": 0, "decode": 4 * 7,
                                                                              "tensor_core": 4}
    assert blocks.DROPPED.calls == 4 * 8 and blocks.DROPPED.routed == 4 * (256 + 7 * 4) * 4
    assert 0 <= blocks.DROPPED.dropped < blocks.DROPPED.routed
    pins.extend(calls)
    calls.clear()
    want = run(build_model(cfg, attention=fa.attention_plain))
    assert len(calls) == len(pins) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 0.5 and float((got - want).abs().mean()) < 0.05


# -- MLA attention (deepseek-v3): the (192, 128) tensor-core forward, the latent decode kernel --------


#: chip_smoke.py phase 2's (192, 128) cases, cut in batch: (b, hq, hkv, sq, sk, kw); NaN past kv_len where given
_MLA_TC_CASES = [
    (1, 128, 128, 512, 512, dict(causal=True)),
    (2, 16, 16, 77, 77, dict(causal=True)),
    (2, 16, 16, 256, 400, dict(causal=False, kv_len=300, nan=True)),
    (1, 16, 16, 64, 600, dict(causal=True, q_offset=500, kv_len=564, nan=True)),
    (1, 32, 8, 130, 130, dict(causal=True)),
    (2, 8, 8, 1, 40, dict(causal=True, q_offset=39, kv_len=40)),
]


@pytest.mark.parametrize("case", _MLA_TC_CASES, ids=lambda c: "x".join(map(str, c[:5])) + "".join(sorted(c[5])))
def test_tensor_core_forward_at_mla_widths_equals_plain(dev, case):
    """q/k 192, v 128 on the tensor_core route, one launch a call, within
    the bf16 tolerance of the plain version (which reads zeros where the
    kernel's K/V hold NaN past kv_len), bit-equal on a rerun; the
    log-sum-exp beside it too."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, kw = case
    kw = dict(kw)
    nan = kw.pop("nan", False)
    g = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16) for s in ((b, hq, sq, 192), (b, hkv, sk, 192)))
    v = torch.randn((b, hkv, sk, 128), generator=g, device=dev).to(torch.bfloat16)
    kz, vz = k.clone(), v.clone()
    if nan:
        kz[:, :, kw["kv_len"]:] = 0
        vz[:, :, kw["kv_len"]:] = 0
        k[:, :, kw["kv_len"]:] = float("nan")
        v[:, :, kw["kv_len"]:] = float("nan")
    assert fa._route(q, k, v=v) == "tensor_core"
    before = fa.ROUTE_LAUNCHES["tensor_core"].value
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.ROUTE_LAUNCHES["tensor_core"].value == before + 1 and got.shape == (b, hq, sq, 128)
    _flash_close(got, fa.attention_plain(q, kz, vz, **kw), torch.bfloat16)
    assert torch.equal(fa.flash_attention(q, k, v, **kw), got)
    out, lse = fa.launch_route("tensor_core", q, k, v, with_lse=True, **kw)
    assert torch.equal(out, got)
    torch.testing.assert_close(lse, fa.attention_lse_plain(q, kz, **kw), rtol=2e-5, atol=2e-5)


#: (b, heads, slots, kv_len, NaN in the dead slots): chip_smoke.py phase 2's
_MLA_DECODE_CASES = [(4, 128, 528, 528, False), (4, 128, 528, 1, True), (4, 128, 528, 65, True),
                     (4, 128, 528, 527, True), (1, 128, 528, 528, False), (4, 16, 528, 400, True),
                     (2, 4, 100, 33, True), (3, 100, 2000, 1999, True), (4, 128, 8192, 8192, False),
                     (4, 128, 8192, 4099, True)]


@pytest.mark.parametrize("case", _MLA_DECODE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_mla_decode_kernel_equals_plain(dev, case):
    """The absorbed decode's kernel against ``mla_decode_plain`` within 2e-5
    of the output's max |value| (f32 throughout), one launch a call, NaN in
    the dead cache slots never read, bit-equal on a rerun; the cache read
    in place from a layer's slice of a stacked cache."""
    from repro_torch.kernels import mla_decode as md

    b, h, smax, kv_len, nan = case
    g = torch.Generator(device=dev).manual_seed(kv_len + h)

    def rand(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    qa, qr = rand(b, h, 1, 512), rand(b, h, 1, 64)
    stacked = rand(2, b, smax, 512), rand(2, b, smax, 64)
    ckv, kr = stacked[0][1], stacked[1][1]
    if nan:
        ckv[:, kv_len:] = float("nan")
        kr[:, kv_len:] = float("nan")
    before = md.LAUNCHES.value
    got = md.mla_decode(qa, qr, ckv, kr, kv_len=kv_len, scale=192 ** -0.5)
    assert md.LAUNCHES.value == before + 1 and got.shape == (b, h, 1, 512) and got.dtype == torch.float32
    want = md.mla_decode_plain(qa, qr, ckv, kr, kv_len=kv_len, scale=192 ** -0.5)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert torch.equal(md.mla_decode(qa, qr, ckv, kr, kv_len=kv_len, scale=192 ** -0.5), got)
    split = md.mla_decode_split_plain(qa, qr, ckv, kr, kv_len=kv_len, scale=192 ** -0.5)
    assert float((got - split).abs().max()) <= 2e-5 * float(want.abs().max())


def test_mla_decoder_serves_on_the_card(dev, monkeypatch):
    """A narrow deepseek-v3 (4 layers: 3 dense, 1 of 16 experts top-4 + a
    shared one; 16 heads at the published MLA widths, d_model 1024) in
    bf16: the prefill on the tensor-core route at (192, 128), the decode
    steps on the mla_decode kernel and nothing on the decode or f32 routes,
    each step's logits within phase 5's bounds of the same calls replayed
    with the plain attentions, the replay following the served experts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as md
    from repro_torch.models import blocks, build_model
    from repro_torch.models.params import init_params

    cfg = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(cfg, num_layers=4, d_model=1024, num_heads=16, num_kv_heads=16, vocab=1024,
                              moe=dataclasses.replace(cfg.moe, num_experts=16, top_k=4, d_expert=256, d_ff_dense=512))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    toks = torch.randint(0, cfg.vocab, (4, 72), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    route, calls, pins = blocks.route, [], []

    def recording(cfg, p, flat, experts=None):
        top_p, top_e = route(cfg, p, flat, pins[len(calls)] if pins else None)
        calls.append(top_e)
        return top_p, top_e

    monkeypatch.setattr(blocks, "route", recording)

    def run(model):
        logits, cache, n = model.prefill(params, {"tokens": toks[:, :64]}, max_len=72)
        steps = [logits[:, -1]]
        for t in range(64, 71):
            logits, cache = model.decode(params, cache, toks[:, t : t + 1], n)
            n += 1
            steps.append(logits[:, -1])
        return torch.stack(steps, 1)

    before = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
    latent = md.LAUNCHES.value
    got = run(build_model(cfg))
    assert {r: c.value - before[r] for r, c in fa.ROUTE_LAUNCHES.items()} == {"f32": 0, "decode": 0, "tensor_core": 4}
    assert md.LAUNCHES.value - latent == 4 * 7
    pins.extend(calls)
    calls.clear()
    want = run(build_model(cfg, attention=fa.attention_plain, latent_attention=md.mla_decode_plain))
    assert len(calls) == len(pins) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 0.5 and float((got - want).abs().mean()) < 0.05


# -- the tensor-core forward's wide plans: (192, 128) and (256, 256) -----------------------------------------


def _wide_check(dev, fa, b, hq, hkv, sq, sk, d, dv, seed, *, scale=1.0, **kw):
    """One wide-plan call against the plain version (zeros where K/V hold
    NaN past kv_len), one tensor_core launch, the lse against
    ``attention_lse_plain``, bit-equal on a rerun."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = ((torch.randn(s, generator=g, device=dev) * scale).to(torch.bfloat16)
            for s in ((b, hq, sq, d), (b, hkv, sk, d)))
    v = torch.randn((b, hkv, sk, dv), generator=g, device=dev).to(torch.bfloat16)
    kv_len = kw.get("kv_len") or sk
    kz, vz = k.clone(), v.clone()
    kz[:, :, kv_len:] = 0
    vz[:, :, kv_len:] = 0
    k[:, :, kv_len:] = float("nan")
    v[:, :, kv_len:] = float("nan")
    assert fa._route(q, k, v=v) == "tensor_core"
    got = _routed(fa, "tensor_core", lambda: fa.flash_attention(q, k, v, **kw))
    assert got.shape == (b, hq, sq, dv) and torch.isfinite(got).all()
    _flash_close(got, fa.attention_plain(q, kz, vz, **kw), torch.bfloat16)
    assert torch.equal(fa.flash_attention(q, k, v, **kw), got)
    out, lse = fa.launch_route("tensor_core", q, k, v, with_lse=True, **kw)
    assert torch.equal(out, got)
    torch.testing.assert_close(lse, fa.attention_lse_plain(q, kz, **kw), rtol=2e-5, atol=2e-5)


_WIDE_DIMS = [(192, 128), (256, 256)]


@pytest.mark.parametrize("sq", [127, 128, 129, 255, 256, 257, 511, 512, 513])
@pytest.mark.parametrize("dims", _WIDE_DIMS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_wide_plans_at_item_edges(dev, dims, sq):
    """Sq on both sides of the 128-row items, a prefix cached before the
    rows (q_offset 40), kv_len < Sk with NaN past it; MLA's heads of their
    own K/V (64 of them: the head-major list), gemma2's 8/4 heads with
    softcap 50 at 256."""
    from repro_torch.kernels import flash_attention as fa

    d, dv = dims
    b, hq, hkv, cap = (2, 64, 64, 0.0) if d == 192 else (2, 8, 4, 50.0)
    kv_len = 40 + sq
    _wide_check(dev, fa, b, hq, hkv, sq, kv_len + 30, d, dv, sq + d, causal=True, q_offset=40, kv_len=kv_len,
                softcap=cap)


@pytest.mark.parametrize("case", [(1, 8, 4, 1100, 1024), (1, 8, 4, 1100, 0), (2, 64, 64, 300, 100), (2, 64, 64, 300, 0),
                                  (1, 8, 4, 700, 8)], ids=lambda c: "x".join(map(str, c)))
def test_wide_head_dim_256_window_and_global(dev, case):
    """gemma2's local (window) and global layers at head_dim 256, softcap 50,
    on both work lists (8/4 heads: tile-major; 64 heads of their own K/V:
    head-major)."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, window = case
    _wide_check(dev, fa, b, hq, hkv, sq, sq, 256, 256, sq + window, causal=True, window=window, softcap=50.0)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("dims", _WIDE_DIMS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_wide_plans_gqa_groups(dev, dims, group):
    from repro_torch.kernels import flash_attention as fa

    d, dv = dims
    _wide_check(dev, fa, 2, 2 * group, 2, 200, 260, d, dv, group * 10 + d, causal=True, q_offset=60, kv_len=260,
                softcap=30.0 if d == 256 else 0.0)


@pytest.mark.parametrize("dims", _WIDE_DIMS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_wide_plans_not_causal_on_a_strided_cache(dev, dims):
    """Not causal, kv_len < Sk, K and V read in place from a layer's slice
    of a wider cache."""
    from repro_torch.kernels import flash_attention as fa

    d, dv = dims
    g = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn((2, 16, 130, d), generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn((2, 3, 16, 400, d), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((2, 3, 16, 400, dv), generator=g, device=dev).to(torch.bfloat16)
    k, v = kc[:, 1], vc[:, 1]
    kw = dict(causal=False, kv_len=333)
    got = _routed(fa, "tensor_core", lambda: fa.flash_attention(q, k, v, **kw))
    _flash_close(got, fa.attention_plain(q, k, v, **kw), torch.bfloat16)
    assert torch.equal(fa.flash_attention(q, k, v, **kw), got)


@pytest.mark.parametrize("scale", [8.0, 64.0])
def test_wide_softcap_saturates(dev, scale):
    """|scores| far past the softcap (dots of q and k scaled up): the tanh
    saturates at +-c as the plain version's does."""
    from repro_torch.kernels import flash_attention as fa

    _wide_check(dev, fa, 1, 8, 4, 300, 300, 256, 256, int(scale), scale=scale, causal=True, softcap=50.0)


def _softcap_samples(dev, c: float, n: int = 4096):
    """q, k at head_dim 256 whose row i meets only key i (window 1), with
    one nonzero element each, so the dot x_i * 16 is exact in f32 and the
    scaled score is x_i (bf16 values on a sweep through +-12 c); then the
    forward's lse of row i is the kernel's softcapped score itself."""
    x = torch.linspace(-12 * c, 12 * c, n, device=dev).to(torch.bfloat16)
    q = torch.zeros((1, 1, n, 256), device=dev, dtype=torch.bfloat16)
    k = torch.zeros_like(q)
    q[0, 0, :, 0] = x
    k[0, 0, :, 0] = 16.0
    return q, k, x.double()


@pytest.mark.parametrize("c", [50.0, 30.0])
def test_wide_softcap_against_tanh(dev, c):
    """The kernel's softcap (ex2.approx and rcp.approx) against tanh in
    double and against c * tanh(x / c) in f32 on the card (the backward's
    recomputation): within 1e-6 c of both."""
    from repro_torch.kernels import flash_attention as fa

    q, k, x = _softcap_samples(dev, c)
    _, lse = fa.launch_route("tensor_core", q, k, k, causal=True, window=1, softcap=c, with_lse=True)
    got = lse[0, 0].double()
    assert float((got - c * torch.tanh(x / c)).abs().max()) <= 1e-6 * c
    assert float((got - (c * torch.tanh(x.float() / c)).double()).abs().max()) <= 1e-6 * c


# -- deepseek-v3 trained: the (192, 128) tensor-core backward, the CUDA-core routes at (24, 16) ----------------


#: (b, hq, hkv, sq, sk, causal, softcap, q_offset, kv_len): the (192, 128)
#: backward at phase 12's training shape (2 x 2 sequences of 576, 128 heads
#: of their own K/V), then G 1 and 2, Sq off the 64-row tiles, kv_len < Sk
#: with NaN past it, a q_offset, a softcap
_MLA_BWD_CASES = [
    (4, 128, 128, 576, 576, True, 0.0, 0, None),
    (2, 16, 16, 77, 77, True, 0.0, 0, None),
    (2, 16, 8, 130, 130, True, 0.0, 0, None),
    (2, 16, 16, 256, 400, False, 0.0, 0, 300),
    (1, 16, 8, 64, 600, True, 0.0, 500, 564),
    (1, 16, 16, 200, 260, True, 0.0, 40, 240),
    (2, 8, 4, 100, 100, True, 30.0, 0, None),
]


def _mla_inputs(dev, seed, b, hq, hkv, sq, sk, d, dv, dtype, kv_len=None):
    """q [b, hq, sq, d], k [b, hkv, sk, d], v [b, hkv, sk, dv] and dout, with
    NaN in K/V past kv_len, and the copies with zeros there that the plain
    version reads."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn(s, generator=g, device=dev).to(dtype) for s in ((b, hq, sq, d), (b, hkv, sk, d)))
    v = torch.randn((b, hkv, sk, dv), generator=g, device=dev).to(dtype)
    dout = torch.randn((b, hq, sq, dv), generator=g, device=dev).to(dtype)
    kz, vz = k.clone(), v.clone()
    if kv_len is not None:
        kz[:, :, kv_len:] = 0
        vz[:, :, kv_len:] = 0
        k[:, :, kv_len:] = float("nan")
        v[:, :, kv_len:] = float("nan")
    return q, k, v, dout, kz, vz


@pytest.mark.parametrize("case", _MLA_BWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_mla_backward_on_the_tensor_cores_equals_plain(dev, case):
    """bf16 at q/k 192, v 128: the tensor_core backward (pre, then the one
    dkdv_dq launch) on the forward's own output and lse, against
    attention_backward_plain within the bf16 tolerance of each gradient's
    max |value|; dV at v's width (dV's shape is v's), zeros for the keys no
    row sees, the same bits on a rerun."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, causal, cap, q_offset, kv_len = case
    kw = dict(causal=causal, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    q, k, v, dout, kz, vz = _mla_inputs(dev, sq + hq, b, hq, hkv, sq, sk, 192, 128, torch.bfloat16, kv_len)
    assert fa._route(q, k, grad=True, v=v) == "tensor_core" and fa._bwd_route(q, v) == "tensor_core"
    out, lse = fa.launch_route("tensor_core", q, k, v, with_lse=True, **kw)
    before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    got = fa.launch_backward(q, k, v, out, lse, dout, **kw)
    launched = {n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()}
    assert launched == {n: int(n in ("tensor_core/pre", "tensor_core/dkdv_dq")) for n in fa.BWD_LAUNCHES}
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    want = fa.attention_backward_plain(q, kz, vz, out, lse, dout, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= _FLASH_TOL[torch.bfloat16], (name, _rel_err(g, w))
    dead = _dead_keys((b, hq, hkv, sq, sk, causal, cap, q_offset, kv_len, 0)).to(dev)
    assert not got[1][:, :, dead].any() and not got[2][:, :, dead].any()
    again = fa.launch_backward(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_mla_backward_through_the_function(dev):
    """The autograd Function at (192, 128): the tensor_core forward with the
    lse, then the tensor_core backward, against autograd through the plain
    attention."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, dout, _, _ = _mla_inputs(dev, 5, 2, 16, 16, 200, 200, 192, 128, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.BWD_LAUNCHES["tensor_core/dkdv_dq"].value
    got = torch.autograd.grad(_routed(fa, "tensor_core", lambda: fa.flash_attention(*leaves)), leaves, dout)
    assert fa.BWD_LAUNCHES["tensor_core/dkdv_dq"].value == before + 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*ref), ref, dout)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and _rel_err(g, w) <= _FLASH_TOL[torch.bfloat16], (name, _rel_err(g, w))


def test_tensor_core_pre_sums_over_v_width(dev):
    """The tensor-core pre kernel at (192, 128), called through its C entry
    point: each query tile's stats hold the rows' lse times log2 e and D_i =
    rowsum(dO * O) over v's 128 columns (zeros past Sq)."""
    import ctypes
    import math

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk = 2, 8, 8, 100, 100
    q, k, v, dout, _, _ = _mla_inputs(dev, 11, b, hq, hkv, sq, sk, 192, 128, torch.bfloat16)
    out, lse = fa.launch_route("tensor_core", q, k, v, with_lse=True, causal=True)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    nq = -(-sq // fa.TC_BWD_TILE)
    stats = torch.full((b * hq * nq * 2 * fa.TC_BWD_TILE,), float("nan"), device=dev)
    tensors = (q, k, v, out, dout, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(st for t in tensors for st in t.stride()[:3]))
    err = build.library().th_flash_bwd_tc_pre(*(t.data_ptr() for t in tensors), lse.data_ptr(), stats.data_ptr(),
                                              ctypes.addressof(strides), b, hq, hkv, sq, sk, 192, 128, 1, 0.0, 0, sk,
                                              0, build.stream_ptr(dev))
    build.check("th_flash_bwd_tc_pre", err)
    st = stats.view(b, hq, nq, 2, fa.TC_BWD_TILE)
    di = st[:, :, :, 1].reshape(b, hq, -1)
    lse2 = st[:, :, :, 0].reshape(b, hq, -1)
    want = (dout.float() * out.float()).sum(-1)
    torch.testing.assert_close(di[..., :sq], want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse2[..., :sq], lse * math.log2(math.e), rtol=1e-6, atol=1e-6)
    assert not di[..., sq:].any() and not lse2[..., sq:].any()


#: (b, hq, hkv, sq, sk, causal, q_offset, kv_len) at the reduced deepseek-v3's
#: (24, 16): launch.train's shape (8 x 64, 4 heads), Sq off the tiles, G 4,
#: kv_len < Sk with NaN past it and a q_offset
_NARROW_MLA_CASES = [
    (8, 4, 4, 64, 64, True, 0, None),
    (2, 4, 4, 77, 77, True, 0, None),
    (1, 8, 2, 130, 130, True, 0, None),
    (2, 4, 4, 100, 200, False, 0, 150),
    (1, 8, 2, 64, 300, True, 200, 264),
]


def _flanked(t, width, lo):
    """``t`` as a view of columns [lo, lo + width) of a wider tensor whose
    other columns hold NaN: a kernel that reads past the view's width
    returns NaN."""
    wide = torch.full((*t.shape[:3], width + 16), float("nan"), device=t.device, dtype=t.dtype)
    view = wide[..., lo : lo + width]
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", _NARROW_MLA_CASES, ids=lambda c: "x".join(map(str, c)))
def test_mla_pair_24_16_on_the_cuda_core_routes(dev, case, dtype):
    """q/k 24, v 16 (the reduced deepseek-v3) on the f32 forward, its lse,
    and the cuda_core backward, against the plain versions within the
    dtype's tolerance; the inputs are views inside wider tensors with NaN
    around them (no column past a view is read); each output at its own
    width and finite; the backward's bits the same on a rerun."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, causal, q_offset, kv_len = case
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    q0, k0, v0, dout0, kz, vz = _mla_inputs(dev, sq + hq, b, hq, hkv, sq, sk, 24, 16, dtype, kv_len)
    q, k, v, dout = _flanked(q0, 24, 8), _flanked(k0, 24, 0), _flanked(v0, 16, 8), _flanked(dout0, 16, 16)
    assert fa._route(q, k, grad=True, v=v) == "f32" and fa._bwd_route(q, v) == "cuda_core"
    assert fa._aligned(q) is q and fa._aligned(v) is v  # read in place, not copied
    before = fa.ROUTE_LAUNCHES["f32"].value
    out, lse = fa.launch_route("f32", q, k, v, with_lse=True, **kw)
    assert fa.ROUTE_LAUNCHES["f32"].value == before + 1 and out.shape == (b, hq, sq, 16)
    tol = _FLASH_TOL[dtype]
    _flash_close(out, fa.attention_plain(q0, kz, vz, **kw), dtype)
    torch.testing.assert_close(lse, fa.attention_lse_plain(q0, kz, **kw), rtol=2e-5, atol=2e-5)
    launched = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    got = fa.launch_backward(q, k, v, out, lse, dout, **kw)
    assert {n: c.value - launched[n] for n, c in fa.BWD_LAUNCHES.items()} == _launched_once(fa, "cuda_core", 24)
    want = fa.attention_backward_plain(q0, kz, vz, out, lse, dout0, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == dtype and torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= tol, (name, _rel_err(g, w))
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()
    again = fa.launch_backward(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_mla_pair_24_16_through_the_function(dev):
    """The Function at (24, 16) in f32, as launch.train's reduced deepseek-v3
    calls it: the f32 forward and the cuda_core backward, against autograd
    through the plain attention."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, dout, _, _ = _mla_inputs(dev, 3, 8, 4, 4, 64, 64, 24, 16, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    got = torch.autograd.grad(_routed(fa, "f32", lambda: fa.flash_attention(*leaves)), leaves, dout)
    assert {n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()} == _launched_once(fa, "cuda_core", 24)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*ref), ref, dout)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and _rel_err(g, w) <= _FLASH_TOL[torch.float32], (name, _rel_err(g, w))


@pytest.mark.parametrize("pair", [(192, 128, torch.float32), (192, 128, torch.float16), (24, 8, torch.float32),
                                  (128, 64, torch.bfloat16)], ids=lambda p: str(p))
def test_backward_refuses_other_pairs_on_the_card(dev, pair):
    from repro_torch.kernels import flash_attention as fa

    d, dv, dtype = pair
    q, k, v, _, _, _ = _mla_inputs(dev, 1, 1, 4, 4, 16, 16, d, dv, dtype)
    with pytest.raises(NotImplementedError, match=rf"\({d}, {dv}\)"):
        fa.flash_attention(q.requires_grad_(), k, v)


def test_mla_decoder_grpo_step_on_the_card(dev, monkeypatch):
    """A narrow deepseek-v3 (4 layers: 3 dense, 1 of 16 experts top-4 + a
    shared one; 16 heads at the published MLA widths, d_model 1024) in bf16
    takes one GRPO step's gradients on the card: each layer's attention on
    the tensor-core forward and backward at (192, 128), nothing on the
    CUDA-core kernels; every tensor's gradient finite and nonzero, within
    chip_smoke.py's gates of a step with the plain attention (5e-2 relative
    L2) and of a step with the same kernel forward and the plain backward
    (2e-2 of its max |value|), each reference routed as the step was."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import blocks, build_model
    from repro_torch.models.params import init_params
    from repro_torch.training.steps import make_grpo_loss_fn, value_and_grad

    cfg = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(cfg, num_layers=4, d_model=1024, num_heads=16, num_kv_heads=16, vocab=1024,
                              moe=dataclasses.replace(cfg.moe, num_experts=16, top_k=4, d_expert=256, d_ff_dense=512))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    b, s, prompt = 4, 200, 64
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)
    model = build_model(cfg)
    with torch.no_grad():  # on-policy behavior logprobs: every ratio 1, no clip zeroes a gradient
        lp = torch.log_softmax(model.forward(params, {"tokens": toks})[:, :-1].float(), -1)
        lp = lp.gather(-1, toks[:, 1:, None])[..., 0]
    mask = torch.zeros((b, s - 1), dtype=torch.bool, device=dev)
    mask[:, prompt - 1 :] = True
    batch = {"tokens": toks, "behavior_logprobs": torch.where(mask, lp, 0.0), "loss_mask": mask,
             "advantages": torch.randn(b, generator=g, device=dev)}
    route, calls, pins = blocks.route, [], []

    def recording(cfg, p, flat, experts=None):
        top_p, top_e = route(cfg, p, flat, pins[len(calls)] if pins else None)
        calls.append(top_e)
        return top_p, top_e

    monkeypatch.setattr(blocks, "route", recording)
    before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    routes = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
    grads, _ = value_and_grad(make_grpo_loss_fn(model), params, batch)
    assert {r: c.value - routes[r] for r, c in fa.ROUTE_LAUNCHES.items()} == {"f32": 0, "decode": 0, "tensor_core": 4}
    assert {n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()} == {
        n: 4 * (n in ("tensor_core/pre", "tensor_core/dkdv_dq")) for n in fa.BWD_LAUNCHES}
    pins.extend(calls)

    class KernelForwardPlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, kw):
            out, lse = fa.launch_route(fa._route(q, k, grad=True, v=v), q, k, v, with_lse=True, **kw)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.kw = kw
            return out

        @staticmethod
        def backward(ctx, dout):
            return (*fa.attention_backward_plain(*ctx.saved_tensors, dout, **ctx.kw), None)

    refs = {}
    for name, attention in (("plain", fa.attention_plain),
                            ("plain_backward", lambda q, k, v, **kw: KernelForwardPlainBackward.apply(q, k, v, kw))):
        calls.clear()
        refs[name], _ = value_and_grad(make_grpo_loss_fn(build_model(cfg, attention=attention)), params, batch)
        assert len(calls) == len(pins)
    for n, gk in grads.items():
        assert torch.isfinite(gk).all() and gk.abs().max() > 0, n
        want = refs["plain"][n].float()
        l2 = float((gk.float() - want).norm() / want.norm().clamp_min(1e-30))
        assert l2 <= 5e-2, (n, l2)
        assert _rel_err(gk, refs["plain_backward"][n]) <= 2e-2, (n, _rel_err(gk, refs["plain_backward"][n]))


# -- the VLM family (internvl2-2b): a GQA group of 2 at head_dim 128, the simulator beside the card -------------

#: internvl2-2b's attention at chip_smoke.py phase 14's shapes (16 query and
#: 8 KV heads of 128): the served prefill of 256 patches + 512 tokens and
#: its last decode step against the cache of 832 slots
_VLM_FORWARD = {"tensor_core": (4, 16, 8, 768, 768, dict(causal=True)),
                "decode": (4, 16, 8, 1, 832, dict(causal=True, q_offset=831, kv_len=832))}


@pytest.mark.parametrize("route", list(_VLM_FORWARD))
def test_internvl2_group_of_2_on_its_forward_routes(dev, route):
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, kw = _VLM_FORWARD[route]
    q, k, v = _qkv(dev, sq + 2, b, hq, hkv, sq, sk, 128, torch.bfloat16)
    assert fa._route(q, k) == route
    before = fa.ROUTE_LAUNCHES[route].value
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.ROUTE_LAUNCHES[route].value == before + 1
    _flash_close(got, fa.attention_plain(q, k, v, **kw), torch.bfloat16)


def test_internvl2_serves_its_patches_on_the_card(dev):
    """internvl2-2b's widths (d_model 2048, 16/8 heads of 128) at 2 layers,
    a narrow FFN and vocab, 64 patches, bf16: the prefill of patches and
    tokens on the tensor_core route, the decode steps from ``P +
    prompt_len`` on the decode route, against a forward with the plain
    attention."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config("internvl2-2b"), num_layers=2, d_ff=1024, vocab=1024, num_patches=64)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    model, ref = build_model(cfg), build_model(cfg, attention=fa.attention_plain)
    g = torch.Generator(device=dev).manual_seed(1)
    patches = (torch.randn((2, 64, cfg.d_model), generator=g, device=dev) / math.sqrt(cfg.vocab)).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2, 52), generator=g, device=dev)
    before = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
    logits, cache, n = model.prefill(params, {"tokens": toks[:, :40], "patches": patches}, max_len=64 + 52)
    assert n == 64 + 40
    steps = [logits[:, -1]]
    for t in range(40, 51):
        logits, cache = model.decode(params, cache, toks[:, t : t + 1], n)
        n += 1
        steps.append(logits[:, -1])
    launched = {r: c.value - before[r] for r, c in fa.ROUTE_LAUNCHES.items()}
    assert launched == {"f32": 0, "decode": 2 * 11, "tensor_core": 2}
    want = ref.forward(params, {"tokens": toks, "patches": patches})[:, 64 + 39 : 64 + 51]
    got = torch.stack(steps, 1)
    assert torch.isfinite(got).all() and float((got - want).abs().max()) < 0.5


def test_train_entry_point_on_the_reduced_internvl2(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train

    before = fa.ROUTE_LAUNCHES["f32"].value, fa.BWD_LAUNCHES["cuda_core/dkdv"].value
    train.main(["--arch", "internvl2-2b", "--steps", "2"])
    assert fa.ROUTE_LAUNCHES["f32"].value - before[0] == 2 * 4
    assert fa.BWD_LAUNCHES["cuda_core/dkdv"].value - before[1] == 2 * 4


def test_simcluster_beside_a_live_cuda_context(dev):
    """The simulator on the H100 profile next to a live CUDA context: a
    cross-DC TP-4 -> TP-2 int8 pull completes, its decode part drained at
    a third of the profile's HBM rate, and no kernel launches and no
    device memory moves."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.transfer import hardware
    from repro_torch.transfer.simcluster import SimCluster

    live = torch.ones(1 << 20, device=dev)
    torch.cuda.synchronize(dev)
    counters = (ck.LAUNCHES, qk.LAUNCHES, rk.LAUNCHES, fk.LAUNCHES, fa.LAUNCHES)
    before = [c.value for c in counters], torch.cuda.memory_allocated(dev)
    units = [1 << 30] * 8
    cl = SimCluster(wan_codec="int8")
    tr = cl.add_replica("m", "tr", 4, global_unit_bytes=units)
    ro = cl.add_replica("m", "ro", 2, datacenter="dc1", global_unit_bytes=units)
    tr.open()
    ro.open()
    cl.run()
    tr.publish(0)
    cl.run()
    ev = ro.replicate("latest")
    cl.run()
    assert ev.triggered and ev.error is None and cl.server.replica_version("m", "ro") == 0
    decode = cl.stall_decomposition(["ro"])["decode"]
    assert 0 < decode <= 2 * (1 << 30) * 2 / (hardware.H100.hbm_bw / 3.0)  # at most two units' drain a shard
    assert ([c.value for c in counters], torch.cuda.memory_allocated(dev)) == before
    assert float(live.sum()) == float(1 << 20)


# -- the audio family (hubert-xlarge): head_dim 80 on the four kernels it launches ----------------

#: (b, hq, hkv, sq, sk, d, causal, q_offset, kv_len, window, softcap) at
#: head_dim 80, as _WINDOW_CASES (NaN in K and V past kv_len): hubert's
#: bidirectional attention at G 1 and S 77, causal, G 2 and 4, a softcap,
#: windows of 64 and 4096, q_offset > 0, and its 1000 frames
_HD80_CASES = [
    (2, 4, 4, 77, 77, 80, False, 0, None, 0, 0.0),
    (2, 4, 4, 77, 77, 80, True, 0, None, 0, 0.0),
    (1, 8, 4, 200, 200, 80, False, 0, None, 0, 50.0),
    (1, 8, 2, 130, 130, 80, True, 0, None, 64, 0.0),
    (1, 8, 2, 64, 300, 80, True, 200, 264, 0, 0.0),
    (1, 4, 2, 100, 160, 80, False, 0, 120, 4096, 0.0),
    (1, 4, 4, 1000, 1000, 80, False, 0, None, 0, 0.0),
]
_HD80_IDS = ["x".join(map(str, c)) for c in _HD80_CASES]


@pytest.mark.parametrize("route,dtype", [("tensor_core", torch.bfloat16), ("f32", torch.float32),
                                         ("f32", torch.float16), ("f32", torch.bfloat16)])
@pytest.mark.parametrize("case", _HD80_CASES, ids=_HD80_IDS)
def test_head_dim_80_forwards_equal_plain(dev, case, route, dtype):
    """The tensor_core forward (bf16) and the f32 forward (f32, f16, bf16
    named) at head_dim 80, with the log-sum-exp, against the plain version
    (dead slots zeroed): within test_kernels.py's tolerance, the lse within
    2e-5, and the same bits on a rerun."""
    from repro_torch.kernels import flash_attention as fa

    (q, k, v), (kz, vz), kw = _window_inputs(dev, case, dtype)
    assert fa._route(q, k, grad=True) == ("tensor_core" if dtype == torch.bfloat16 else "f32")
    out, lse = _routed(fa, route, lambda: fa.launch_route(route, q, k, v, with_lse=True, **kw))
    again = fa.launch_route(route, q, k, v, with_lse=True, **kw)
    assert out.shape == q.shape and torch.isfinite(out).all()
    _flash_close(out, fa.attention_plain(q, kz, vz, **kw), dtype)
    torch.testing.assert_close(lse, fa.attention_lse_plain(q, kz, **kw), rtol=2e-5, atol=2e-5)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("route,dtype", [("tensor_core", torch.bfloat16), ("cuda_core", torch.float32),
                                         ("cuda_core", torch.float16), ("cuda_core", torch.bfloat16)])
@pytest.mark.parametrize("case", _HD80_CASES, ids=_HD80_IDS)
def test_head_dim_80_backwards_equal_plain(dev, case, route, dtype):
    """The tensor_core backward (bf16) and the cuda_core backward (f32,
    f16, bf16 named) at head_dim 80 on their forward's output: pre, dkdv
    and dq once each, against autograd through the plain attention (dead
    slots zeroed), zeros past kv_len, and the same bits on a rerun."""
    from repro_torch.kernels import flash_attention as fa

    (q, k, v), (kz, vz), kw = _window_inputs(dev, case, dtype)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(8), device=dev).to(dtype)
    out, lse = fa.launch_route("tensor_core" if route == "tensor_core" else "f32", q, k, v, with_lse=True, **kw)
    before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    got = fa.launch_backward(q, k, v, out, lse, dout, route=route, **kw)
    assert {n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()} == _launched_once(fa, route, 80)
    again = fa.launch_backward(q, k, v, out, lse, dout, route=route, **kw)
    ref = [t.clone().requires_grad_() for t in (q, kz, vz)]
    want = torch.autograd.grad(fa.attention_plain(*ref, **kw), ref, dout)
    _check_grads(got, want, dtype, (kw["kv_len"],))
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [1, 2])
def test_head_dim_80_through_the_models_strided_views(dev, dtype, group):
    """q, k and v as the encoder makes them (``[B, S, H * 80]`` split into
    heads: sequence stride H * 80, head stride 80), through the Function
    on its route and the backward, bidirectional and causal: the
    gradients of the projections against autograd through the plain
    attention. A kernel that stored past a head's 80 columns would write
    into the next head's and fail this."""
    from repro_torch.kernels import flash_attention as fa

    b, s, hq = 2, 150, 4
    hkv = hq // group
    g = torch.Generator(device=dev).manual_seed(group)
    xs = [torch.randn((b, s, h * 80), generator=g, device=dev).to(dtype) for h in (hq, hkv, hkv)]
    dout = torch.randn((b, hq, s, 80), generator=g, device=dev).to(dtype)
    route = "tensor_core" if dtype == torch.bfloat16 else "f32"
    for causal in (False, True):
        leaves = [x.clone().requires_grad_() for x in xs]
        heads = [t.view(b, s, -1, 80).transpose(1, 2) for t in leaves]
        out = _routed(fa, route, lambda: fa.flash_attention(*heads, causal=causal))
        got = torch.autograd.grad(out, leaves, dout)
        ref = [x.clone().requires_grad_() for x in xs]
        want_out = fa.attention_plain(*(t.view(b, s, -1, 80).transpose(1, 2) for t in ref), causal=causal)
        want = torch.autograd.grad(want_out, ref, dout)
        _flash_close(out, want_out, dtype)
        for name, gt, w in zip("qkv", got, want):
            assert torch.isfinite(gt).all() and _rel_err(gt, w) <= _FLASH_TOL[dtype], (name, causal, _rel_err(gt, w))


def test_hubert_encodes_and_trains_on_the_card(dev):
    """hubert-xlarge's widths (d_model 1280, 16 heads of 80, frames of 512)
    at 2 layers and a narrow FFN, bf16: an encode of 2 x 300 frames
    launches one tensor_core forward a layer and nothing else, its logits
    within phase 5's gates of a forward with the plain attention; the
    masked-prediction gradient launches one tensor_core forward and one of
    each tensor_core backward kernel a layer, every gradient finite and
    nonzero and within 5e-2 (relative L2) of the plain attention's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import audio_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params
    from repro_torch.training.steps import make_loss_fn, value_and_grad

    cfg = dataclasses.replace(get_config("hubert-xlarge"), num_layers=2, d_ff=1024)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    model, ref = build_model(cfg), build_model(cfg, attention=fa.attention_plain)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in audio_batch(2, 300, cfg.frontend_dim, cfg.vocab, 0).items()}
    routes = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
    with torch.no_grad():
        got = model.forward(params, batch)
        want = ref.forward(params, batch)
    assert {r: c.value - routes[r] for r, c in fa.ROUTE_LAUNCHES.items()} == {"tensor_core": 2, "decode": 0, "f32": 0}
    assert got.shape == (2, 300, cfg.vocab) and torch.isfinite(got).all()
    diff = (got - want).abs()
    assert float(diff.max()) < 0.5 and float(diff.mean()) < 0.05
    routes = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
    before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    grads, metrics = value_and_grad(make_loss_fn(model, cfg), params, batch)
    assert {r: c.value - routes[r] for r, c in fa.ROUTE_LAUNCHES.items()} == {"tensor_core": 2, "decode": 0, "f32": 0}
    assert {n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()} == {
        n: 2 * (n in ("tensor_core/pre", "tensor_core/dkdv", "tensor_core/dq")) for n in fa.BWD_LAUNCHES}
    want, _ = value_and_grad(make_loss_fn(ref, cfg), params, batch)
    for n, gk in grads.items():
        assert torch.isfinite(gk).all() and gk.abs().max() > 0, n
        w = want[n].float()
        assert float((gk.float() - w).norm() / w.norm().clamp_min(1e-30)) <= 5e-2, n


# -- the hybrid family (zamba2-2.7b): the decode kernel at head_dim 80 --------------------------

#: (b, hq, hkv, sq, sk, causal, q_offset, kv_len, window, softcap) of the
#: decode route at head_dim 80: zamba2's G 1 decode step at kv_len 1, 63,
#: 64, 65 and 576 behind a cache of 576 slots (its served shape), a ring
#: call over 4096 slots (causal=False, every slot live), a softcap, a
#: window, a short chunk at G 2 and a chunk of 16 rows at G 4; K and V past
#: kv_len hold NaN
_HD80_DECODE_CASES = [
    (8, 32, 32, 1, 576, True, 0, 1, 0, 0.0),
    (8, 32, 32, 1, 576, True, 62, 63, 0, 0.0),
    (8, 32, 32, 1, 576, True, 63, 64, 0, 0.0),
    (8, 32, 32, 1, 576, True, 64, 65, 0, 0.0),
    (8, 32, 32, 1, 576, True, 575, 576, 0, 0.0),
    (2, 32, 32, 1, 4096, False, 0, 4096, 0, 0.0),
    (2, 8, 8, 1, 700, True, 599, 600, 0, 30.0),
    (2, 8, 8, 1, 900, True, 799, 800, 100, 0.0),
    (2, 8, 4, 3, 300, True, 197, 200, 0, 0.0),
    (1, 8, 2, 16, 200, True, 150, 166, 64, 50.0),
]
_HD80_DECODE_IDS = ["x".join(map(str, c)) for c in _HD80_DECODE_CASES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _HD80_DECODE_CASES, ids=_HD80_DECODE_IDS)
def test_head_dim_80_decode_route_equals_plain(dev, case, dtype):
    """The decode route's split kernel at head_dim 80 (its own instances:
    10 or 20 chunks a row, threads 120-127 out of P V), through
    ``flash_attention``: one decode launch, within test_kernels.py's
    tolerance of the plain version and of ``split_kv_plain`` (dead slots
    zeroed, the kernel never reads them), finite, and the same bits on a
    rerun."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, causal, q_offset, kv_len, window, cap = case
    q, k, v = _qkv(dev, kv_len + sq, b, hq, hkv, sq, sk, 80, dtype)
    k[:, :, kv_len:] = float("nan")
    v[:, :, kv_len:] = float("nan")
    kz, vz = k[:, :, :kv_len].contiguous(), v[:, :, :kv_len].contiguous()
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window, softcap=cap)
    assert fa._route(q, k) == "decode"
    got = _routed(fa, "decode", lambda: fa.flash_attention(q, k, v, **kw))
    again = fa.flash_attention(q, k, v, **kw)
    assert got.shape == q.shape and torch.isfinite(got).all()
    _flash_close(got, fa.attention_plain(q, kz, vz, **kw), dtype)
    _flash_close(got, fa.split_kv_plain(q, kz, vz, **kw), dtype)
    assert torch.equal(got, again)


def test_head_dim_80_decode_through_a_ring_cache(dev):
    """The ring step as ``HybridLM`` calls it, over an f32 ring of 64
    slots before and after it wraps (``kv_len = min(cache_len + 1, 64)``;
    once wrapped every slot is live and their order is not the
    positions'), through ``_ring_attention_step`` and the flash wrapper:
    one decode launch a step, against the plain attention."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.lm import _ring_attention_step

    q, k, v = _qkv(dev, 7, 4, 32, 32, 1, 64, 80, torch.float32)
    for cache_len in (10, 63, 64, 200):
        got = _routed(fa, "decode", lambda: _ring_attention_step(fa.flash_attention, q, k, v, cache_len, 0.0))
        want = _ring_attention_step(fa.attention_plain, q, k, v, cache_len, 0.0)
        _flash_close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_zamba2_serves_on_the_card(dev, dtype):
    """zamba2's widths (d_model 2560, 32 heads of 80, SSD heads of 64, state
    64, chunk 256) at one group of 6 Mamba2 blocks: a prefill of 2 x 300
    launches one prefill attention (``tensor_core`` in bf16, ``f32`` in f32)
    and each decode step one ``decode`` launch; a ring decode from
    ``init_cache(..., ring=True)`` at a window of 16 launches ``decode`` in
    f32 each step; every logit within phase 5's gates of the model with
    the plain attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=6, d_ff=1024, sliding_window=16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype, dev)
    model, ref = build_model(cfg), build_model(cfg, attention=fa.attention_plain)
    toks = torch.randint(0, cfg.vocab, (2, 310), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    prefill = "tensor_core" if dtype == torch.bfloat16 else "f32"
    with torch.no_grad():
        routes = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
        logits, cache, n = model.prefill(params, {"tokens": toks[:, :300]}, max_len=310)
        got, want = [logits[:, -1]], []
        for t in range(300, 309):
            logits, cache = model.decode(params, cache, toks[:, t : t + 1], t)
            got.append(logits[:, -1])
        assert {r: c.value - routes[r] for r, c in fa.ROUTE_LAUNCHES.items()} == {
            "tensor_core": int(prefill == "tensor_core"), "f32": int(prefill == "f32"), "decode": 9}
        full = ref.forward(params, {"tokens": toks[:, :310]})
        diff = (torch.stack(got, 1) - full[:, 299:309]).abs()
        assert torch.isfinite(diff).all() and float(diff.max()) < 0.5 and float(diff.mean()) < 0.05
        ring, rring = (m.init_cache(2, 40, dtype, dev, ring=True) for m in (model, ref))
        routes = {r: c.value for r, c in fa.ROUTE_LAUNCHES.items()}
        for t in range(40):
            a, ring = model.decode(params, ring, toks[:, t : t + 1], t, ring=True)
            b, rring = ref.decode(params, rring, toks[:, t : t + 1], t, ring=True)
            d = (a - b).abs()
            assert torch.isfinite(a).all() and float(d.max()) < 0.5 and float(d.mean()) < 0.05, t
        assert {r: c.value - routes[r] for r, c in fa.ROUTE_LAUNCHES.items()} == {"tensor_core": 0, "f32": 0,
                                                                                 "decode": 40}


# -- the SSM family (xlstm-350m): the xLSTM blocks in PyTorch ops on the card ----------------


def _scaled_err(got, want) -> float:
    """max |got - want| over max |want|, both taken to the CPU in f64."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("form", ["chunked", "parallel", "step"])
def test_xlstm_mlstm_forms_on_the_card_equal_the_cpu(dev, form):
    """The mLSTM at xlstm-350m's widths (4 heads of 512), B 2, T 300 (the
    chunked form's two chunks of 256, the second padded), f32: each form on
    the card against the same call on the CPU, the outputs and the final
    state within 1e-4 of their max |value| (cuBLAS and the host sum in other
    orders; the normaliser divides by small sums, tests/test_torch_xlstm.py),
    and the form against the chunked one on the card within 2e-3
    (tests/test_blocks.py's bound). ``step``: 16 one-step recurrences from the
    state the chunked form left after 284 positions."""
    from repro_torch.models import xlstm_blocks as xb

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 4, 300, 512, generator=g) for _ in range(3))
    i_raw = torch.randn(2, 4, 300, generator=g)
    f_raw = torch.randn(2, 4, 300, generator=g) + 2.0
    cpu = [q, k, v, i_raw, f_raw]
    card = [t.to(dev) for t in cpu]

    def run(args):
        if form == "chunked":
            return xb._mlstm_chunked(*args)
        if form == "parallel":
            return xb._mlstm_parallel(*args), xb._mlstm_fold_state(*args)
        out, state = xb._mlstm_chunked(*(a[:, :, :284] for a in args))
        outs = []
        for t in range(284, 300):
            o, state = xb._mlstm_step(state, *(a[:, :, t] for a in args))
            outs.append(o)
        return torch.stack(outs, 2), state

    got, got_s = run(card)
    want, want_s = run(cpu)
    assert got.device == dev and torch.isfinite(got).all()
    assert _scaled_err(got, want) <= 1e-4
    for n in want_s:
        assert got_s[n].dtype == torch.float32 and _scaled_err(got_s[n], want_s[n]) <= 1e-4, n
    chunked, _ = xb._mlstm_chunked(*card)
    ref = chunked[:, :, 284:] if form == "step" else chunked
    assert _scaled_err(got, ref) <= 2e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xlstm_blocks_at_the_published_widths_on_the_card(dev, dtype):
    """One mLSTM and one sLSTM block of xlstm-350m (d_model 1024), B 2, T
    40, weights drawn by ``init_params``: the card against the CPU (f32:
    within 1e-4 of the max |value|; bf16: 2e-2 relative L2), the sLSTM split
    at 5 against the whole sequence within 2e-3, its state f32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import xlstm_blocks as xb
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config("xlstm-350m"), num_layers=2, vocab=256)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype, dev)
    m = {n.rsplit("/", 1)[-1]: t[0, 0] for n, t in params.items() if n.startswith("pairs/mlstm/")}
    s = {n.rsplit("/", 1)[-1]: t[0] for n, t in params.items() if n.startswith("pairs/slstm/")}
    x = torch.randn(2, 40, 1024, generator=torch.Generator(device=dev).manual_seed(1), device=dev).to(dtype)
    for fn, p in ((xb.mlstm_block_apply, m), (xb.slstm_block_apply, s)):
        got, st = fn(cfg, p, x)
        want, _ = fn(cfg, {n: t.cpu() for n, t in p.items()}, x.cpu())
        assert got.dtype == dtype and all(t.dtype == torch.float32 for t in st.values())
        if dtype == torch.float32:
            assert _scaled_err(got, want) <= 1e-4
        else:
            rel = float((got.double().cpu() - want.double()).norm() / want.double().norm())
            assert rel <= 2e-2, rel
    whole, _ = xb.slstm_block_apply(cfg, s, x)
    a, st = xb.slstm_block_apply(cfg, s, x[:, :5])
    b, _ = xb.slstm_block_apply(cfg, s, x[:, 5:], cache=st)
    assert _scaled_err(torch.cat([a, b], 1), whole) <= 2e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xlstm_serves_on_the_card_as_on_the_cpu(dev, dtype):
    """The reduced xlstm-350m served on the card: a prefill of 2 x 300 (two
    chunks) and 12 decode steps, against the same calls on the CPU (f32:
    every logit within 1e-4 of the max |value|; bf16: 2e-2 relative L2 over
    the steps), and against the teacher-forced forward on the card within
    phase 5's gates; the cache stays f32 and the calls launch no flash
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params

    cfg = get_config("xlstm-350m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    for n, t in params.items():  # the norms and gate biases away from zero
        if n.endswith(("ln", "b_if", "b_gates")):
            t.normal_(generator=torch.Generator().manual_seed(len(n))).mul_(0.3)
    params = {n: t.to(dtype) for n, t in params.items()}
    on_card = {n: t.to(dev) for n, t in params.items()}
    model = build_model(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 312), generator=torch.Generator().manual_seed(1))

    def serve(p, tk):
        logits, cache, n = model.prefill(p, {"tokens": tk[:, :300]})
        steps = [logits[:, -1]]
        for t in range(300, 311):
            logits, cache = model.decode(p, cache, tk[:, t : t + 1], t)
            steps.append(logits[:, -1])
        assert all(c.dtype == torch.float32 for part in cache.values() for c in part.values())
        return torch.stack(steps, 1)

    before = fa.LAUNCHES.value
    with torch.no_grad():
        got = serve(on_card, toks.to(dev))
        want = serve(params, toks)
        full = model.forward(on_card, {"tokens": toks[:, :311].to(dev)})
    assert fa.LAUNCHES.value == before and torch.isfinite(got).all()
    if dtype == torch.float32:
        assert _scaled_err(got, want) <= 1e-4
    else:
        rel = float((got.double().cpu() - want.double()).norm() / want.double().norm())
        assert rel <= 2e-2, rel
    d = (got - full[:, 299:311]).abs()
    assert float(d.max()) < 0.5 and float(d.mean()) < 0.05


# -- the sharding layer: H2, the smoke mesh, H3's fallback ------------------------------


@pytest.mark.parametrize("shape", [(8, 4096), (3, 7, 1280), (2, 64)])
def test_h2_norm_on_the_card(dev, shape):
    """H2's ``rms_norm`` in bf16 on the card: its own arithmetic (the
    variance in f32, the scale in bf16) as on the CPU, and within bf16's
    2e-2 of the f32 norm computed in float64."""
    from repro_torch.models import optim
    from repro_torch.models.layers import rms_norm

    g = torch.Generator(device=dev).manual_seed(shape[-1])
    x = (torch.randn(shape, generator=g, device=dev) * 3).to(torch.bfloat16)
    gamma = (torch.randn(shape[-1], generator=g, device=dev) * 0.3).to(torch.bfloat16)
    with optim.optimizations(lowp_norm=True):
        got = rms_norm(x, gamma)
        on_cpu = rms_norm(x.cpu(), gamma.cpu())
    xd = x.double()
    exact = xd * torch.rsqrt(xd.square().mean(-1, keepdim=True) + 1e-6) * (1 + gamma.double())
    assert got.dtype == torch.bfloat16 and not torch.equal(got, rms_norm(x, gamma))
    assert (got.double() - exact).abs().max() <= 2e-2 * exact.abs().max()
    assert (got.cpu().float() - on_cpu.float()).abs().max() <= 2e-2 * on_cpu.float().abs().max()


@pytest.fixture()
def smoke_mesh(dev):
    import torch.distributed as dist

    from repro_torch.launch import make_smoke_mesh

    mesh = make_smoke_mesh()
    yield mesh
    dist.destroy_process_group()


def test_smoke_mesh_places_llama3_8b_replicated(smoke_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.models.params import decoder_specs
    from repro_torch.sharding import SERVE_RULES, sharding_for

    assert smoke_mesh.device_type == "cuda" and smoke_mesh.mesh_dim_names == ("data", "model")
    placements = {n: sharding_for(p, SERVE_RULES, smoke_mesh) for n, p in decoder_specs(get_config("llama3-8b"))}
    assert len(placements) == 12 and all(p == (Replicate(), Replicate()) for p in placements.values())
    x = torch.randn(1 << 20, device="cuda")
    dt = distribute_tensor(x, smoke_mesh, placements["embed"][:1] * 2)
    assert torch.equal(dt.to_local(), x) and torch.equal(dt.full_tensor(), x)


def test_h3_falls_back_to_moe_apply_on_one_card(smoke_mesh):
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, optim
    from repro_torch.models.params import init_params

    cfg = get_config("dbrx-132b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    layer = {n: params[f"layers/ffn/{n}"][0] for n in blocks.moe_specs(cfg)}
    x = torch.randn(4, 12, cfg.d_model, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        want = blocks.moe_apply(cfg, layer, x)
        with optim.optimizations(mesh=smoke_mesh, shardmap_moe=True):
            got = blocks.moe_apply_shardmap(cfg, layer, x)
    assert torch.equal(got, want)


def test_sharded_step_on_the_smoke_mesh(smoke_mesh, monkeypatch):
    """``chip_smoke.py`` phase 19 at 2 layers: llama3-8b's train step on
    DTensors placed by ``TRAIN_RULES`` (b) and under H1 (c) against the
    plain step (a), from the same bf16 parameters, within phase 19's gates;
    each step launches one tensor-core forward and backward a layer, at G =
    1 under H1."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, optim
    from repro_torch.models.params import decoder_specs, init_params
    from repro_torch.sharding import TRAIN_RULES, place_tree
    from repro_torch.training import AdamW, make_train_step, steps

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2)
    init = init_params(cfg, torch.Generator(device="cuda").manual_seed(1), torch.bfloat16)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 512), generator=torch.Generator(device="cuda").manual_seed(2),
                                     device="cuda")}
    opt = AdamW()
    seen, kv_heads = {}, []
    value_and_grad = steps.value_and_grad

    def recording(*a, **kw):
        grads, metrics = value_and_grad(*a, **kw)
        seen.update(grads=grads, loss=float(metrics["loss"]))
        return grads, metrics

    def attention(q, k, v, **kw):
        kv_heads.append(k.shape[1])
        return fa.flash_attention(q, k, v, **kw)

    monkeypatch.setattr(steps, "value_and_grad", recording)
    step = make_train_step(build_model(cfg, attention=attention), cfg, opt)

    def run(params, **flags):
        kv_heads.clear()
        before = [fa.ROUTE_LAUNCHES["tensor_core"].value] + [fa.BWD_LAUNCHES[f"tensor_core/{n}"].value
                                                             for n in fa.bwd_kernels(128)]
        with optim.optimizations(**flags):
            step(params, opt.init(params), batch)
        after = [fa.ROUTE_LAUNCHES["tensor_core"].value] + [fa.BWD_LAUNCHES[f"tensor_core/{n}"].value
                                                            for n in fa.bwd_kernels(128)]
        assert [b - a for a, b in zip(before, after)] == [cfg.num_layers] * len(after)
        local = {n: (t.to_local() if optim.is_dtensor(t) else t) for n, t in params.items()}
        grads = {n: (g.to_local() if optim.is_dtensor(g) else g).float() for n, g in seen["grads"].items()}
        return seen["loss"], grads, local, list(kv_heads)

    def placed():
        return place_tree({n: t.clone() for n, t in init.items()}, dict(decoder_specs(cfg)), TRAIN_RULES, smoke_mesh)

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    loss_a, grads_a, params_a, heads_a = run({n: t.clone() for n, t in init.items()})
    loss_b, grads_b, _, heads_b = run(placed())
    loss_c, grads_c, params_c, heads_c = run(placed(), mesh=smoke_mesh, shard_attn_heads=True)
    assert heads_a == heads_b == [cfg.num_kv_heads] * cfg.num_layers and heads_c == [cfg.num_heads] * cfg.num_layers
    assert max(rel_l2(grads_b[n], grads_a[n]) for n in grads_a) <= 1e-6
    assert abs(loss_c - loss_a) <= 1e-3 * abs(loss_a)
    assert max(rel_l2(grads_c[n], grads_a[n]) for n in grads_a) <= 2e-2
    assert max(float((params_c[n].float() - params_a[n].float()).abs().max()) for n in params_a) <= 5e-3


# -- the kernel operators (repro_torch::flash_attention, ::mla_decode) ---------------------

#: (b, hq, hkv, sq, sk, d, dtype, kw): a call of each route the operator takes
_OP_CASES = [
    (2, 8, 2, 256, 256, 128, torch.bfloat16, dict(causal=True)),  # tensor_core
    (2, 8, 2, 1, 700, 128, torch.bfloat16, dict(causal=True, q_offset=699, kv_len=700)),  # decode
    (2, 4, 4, 96, 96, 64, torch.float32, dict(causal=True, window=40)),  # f32
]
_OP_IDS = ["tensor_core", "decode", "f32"]


@pytest.mark.parametrize("case", _OP_CASES, ids=_OP_IDS)
def test_flash_operator_equals_launch_route(dev, case):
    """The operator's forward launches the route ``flash_attention``
    takes, with the same bits, once; its fake gives the card's shape,
    dtype and layout."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, d, dtype, kw = case
    g = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)
               for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    route = fa._route(q, k, v=v)
    before = fa.ROUTE_LAUNCHES[route].value
    got = fa.flash_attention_op(q, k, v, **kw)
    assert fa.ROUTE_LAUNCHES[route].value == before + 1
    assert torch.equal(got, fa.launch_route(route, q, k, v, **kw))
    assert torch.equal(got, fa.flash_attention(q, k, v, **kw))
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    want = fa.attention_plain(q, k, v, **kw).float()
    assert float(((got.float() - want).abs() / (tol + tol * want.abs())).max()) <= 1.0
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fake = fa.flash_attention_op(fq, fk, fv, **kw)
    assert (fake.shape, fake.dtype, fake.stride()) == (got.shape, got.dtype, got.stride())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_operator_gradients_equal_the_function(dev, dtype):
    """Through the operator, the forward with the lse and the backward
    kernels give the gradients the autograd Function gives, bit for bit,
    and within phase 2's tolerance of the plain backward."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(5)
    shapes = ((2, 8, 192, 128), (2, 2, 192, 128), (2, 2, 192, 128))
    base = [torch.randn(s, generator=g, device=dev, dtype=torch.float32).to(dtype) for s in shapes]
    dout = torch.randn(shapes[0], generator=g, device=dev, dtype=torch.float32).to(dtype)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in base]
        return torch.autograd.grad(fn(*leaves, causal=True), leaves, dout)

    route = fa._bwd_route(base[0])
    before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    got = grads(fa.flash_attention_op)
    assert all(fa.BWD_LAUNCHES[f"{route}/{n}"].value == before[f"{route}/{n}"] + 1 for n in fa.bwd_kernels(128))
    want = grads(fa.flash_attention)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    ref = grads(fa.attention_plain)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for a, w in zip(got, ref):
        assert float((a.float() - w.float()).norm() / w.float().norm()) <= tol


def test_mla_operator_equals_the_kernel(dev):
    """The MLA operator launches the kernel once, with its bits."""
    from repro_torch.kernels import mla_decode as md

    g = torch.Generator(device=dev).manual_seed(9)
    b, h, kv = 2, 128, 700
    qa, qr = (torch.randn(b, h, 1, w, generator=g, device=dev).bfloat16() for w in (512, 64))
    ckv, kr = (torch.randn(b, 1024, w, generator=g, device=dev).bfloat16() for w in (512, 64))
    before = md.LAUNCHES.value
    got = md.mla_decode_op(qa, qr, ckv, kr, kv_len=kv, scale=0.07)
    assert md.LAUNCHES.value == before + 1
    assert torch.equal(got, md.launch(qa, qr, ckv, kr, kv_len=kv, scale=0.07))
    want = md.mla_decode_plain(qa, qr, ckv, kr, kv_len=kv, scale=0.07)
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())
