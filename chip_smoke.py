#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and the CUDA toolkit (``nvcc``); without a card it
exits non-zero before printing any result. Phases, each printed on its own
lines, any failure exiting non-zero:

1. The card: torch and CUDA versions, and ``nvidia-smi``'s name and power
   limit line.
2. The kernels: builds the CUDA sources of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, then holds each kernel bit-equal to its plain
   PyTorch version on the card at the transfer path's shapes, and times
   kernel, plain version and a device-to-device ``copy_`` of the same bytes
   (median of CUDA-event timings) beside the bytes bound.
3. Transfer at full width: llama3-8b at its published widths in bf16, depth
   cut from 32 to 10 layers, weights from a seeded generator on the card.
   A trainer (dc0) publishes v0; rollout-0 (dc0) replicates over raw and
   rollout-1 (dc1) over int8; the trainer unpublishes, perturbs 1/8 of its
   256-element rows in place and publishes v1; both rollouts update
   (rollout-1 over delta:int8). rollout-0 must equal the trainer and
   rollout-1 the plain-version codec applied to the same bytes; both
   kernels' launch counters must rise on this path.
4. Resharded transfer at full width: the same model, published by a
   trainer group at TP-4 (dc0) and pulled by two rollout groups at TP-2,
   ``roll-int8`` (dc1, int8 wire frames decoded by the fused dequant+gather
   kernel) and ``roll-raw`` (dc0, staged, repacked by the gather kernel);
   then the trainer perturbs 1/8 of its rows and publishes v1 and both
   groups update. roll-raw must equal the trainer's bytes resharded to
   TP-2, roll-int8 the plain-version int8 codec's round trip of the
   trainer's TP-4 units resharded to TP-2; all four kernels' launch
   counters must rise on this path.
5. Serving at full width: flash attention held against its plain version
   on each of its three routes (phase 2 above also times each route's
   kernel at the serving path's prefill and decode shapes beside the f32 route's
   kernel, the plain version and ``scaled_dot_product_attention``); then
   llama3-8b at all 32 layers in bf16 served from a TensorHub replica: a
   trainer publishes v0, a ``RolloutWorker`` replicates and answers 16
   requests of 512 prompt tokens with 64 new tokens each; the trainer
   perturbs 1/8 of its rows and publishes v1, the worker updates in place
   and answers again. The rollout must equal the trainer bit for bit, its
   logprobs and every step's logits must match a teacher-forced
   ``forward`` with the plain attention on the trainer's weights, round 1
   must differ from round 0, and flash attention must launch exactly 32 x
   (1 + 64) times a round: 32 on the tensor-core route (prefill), 32 x 64
   on the decode route and none on the f32 route.
6. A ``kernels`` JSON line (launches over phases 3, 4 and 5; flash
   attention's entry carries a ``routes`` field with each route's times,
   bound and launches), then the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
NUM_LAYERS = 10  # of llama3-8b's 32: three replicas and their delta bases fit one 80 GB card
GIB = 1 << 30
MASK32 = 0xFFFFFFFF
SRC_TP, DST_TP = 4, 2  # phase 4: trainer and rollout tensor-parallel degrees
W_GATE = "layers/ffn/w_gate"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def memory_rate(name: str) -> tuple:
    """Published HBM rate of the card, by its name."""
    if "PCIe" in name:
        return "H100 PCIe", 2.0e12
    if "NVL" in name:
        return "H100 NVL", 3.9e12
    return "H100 SXM", 3.35e12


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the summed duration of the
    kernels it launches, traced by ``torch.profiler`` over ``reps`` calls.
    For calls shorter than their host launch, where a CUDA-event pair
    around one call measures the host's enqueue as well."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(us > 0, "the profiler saw no device time")
    return us / reps * 1e-3


def cold_ms(torch, fn, flush, reps: int = 20, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn`` with the L2 cache
    evicted before it, as a layer's attention finds it after the other
    layers' weights have streamed through: ``flush`` (a buffer larger than
    the 50 MB L2) is filled first, and the fill outlasts the host's
    enqueue of ``fn``, so the events time the device alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# -- phase 2: kernels against their plain versions ----------------------------


def kernel_checks(torch, dev, bw: float) -> dict:
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import quant as qk
    from repro_torch.transfer.checksum import ZERO_STANDIN, checksum

    g = torch.Generator(device=dev).manual_seed(SEED)
    w_gate_bytes = NUM_LAYERS * 4096 * 14336 * 2
    embed_bytes = 128256 * 4096 * 2
    ln_bucket_bytes = 4096 * 2 + 2 * NUM_LAYERS * 4096 * 2
    raw = torch.randint(0, 256, (w_gate_bytes + 64,), dtype=torch.uint8, generator=g, device=dev)
    cases = {
        "w_gate unit": raw[:w_gate_bytes],
        "w_gate first 1 GiB chunk": raw[:GIB],
        "embed unit": raw[:embed_bytes],
        "ln compact bucket": raw[:ln_bucket_bytes],
        "1 B": raw[:1],
        "3 B": raw[:3],
        "5 B": raw[:5],
        "4097 B": raw[:4097],
        "unaligned view +1, 64 MiB + 3": raw[1 : 1 + (64 << 20) + 3],
        "unaligned view +3, 4097 B": raw[3 : 3 + 4097],
        "zero fold": torch.zeros(4096, dtype=torch.uint8, device=dev),
    }
    worst = 0
    for label, buf in cases.items():
        got = ck.checksum_words(buf).to(torch.int64) & MASK32
        want = ck.checksum_words_plain(buf)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        worst = max(worst, err)
        emit("checksum_check", case=label, nbytes=buf.numel(), equal=err == 0)
        check(err == 0, f"checksum kernel != plain version on {label}")
    check(checksum(cases["zero fold"]) == ZERO_STANDIN, "zero fold not remapped")

    chunk = cases["w_gate first 1 GiB chunk"]
    dst = torch.empty_like(chunk)
    ck_ms = time_ms(torch, lambda: ck.checksum_words(chunk), reps=20)
    ck_plain_ms = time_ms(torch, lambda: ck.checksum_words_plain(chunk), reps=3, warmup=1)
    ck_copy_ms = time_ms(torch, lambda: dst.copy_(chunk), reps=20)
    ck_bound_ms = chunk.numel() / bw * 1e3
    del raw, cases, chunk, dst
    torch.cuda.empty_cache()

    q_cases = {}
    n_chunk = GIB // 2  # a 1 GiB bf16 chunk
    q_cases["1 GiB bf16 chunk"] = torch.randn(n_chunk, generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02)
    q_cases["f32, 16M + 77"] = torch.randn((16 << 20) + 77, generator=g, device=dev, dtype=torch.float32)
    q_cases["f16, 16M"] = torch.randn(16 << 20, generator=g, device=dev, dtype=torch.float16)
    q_cases["bf16 ragged tail, 1M + 77"] = torch.randn((1 << 20) + 77, generator=g, device=dev, dtype=torch.bfloat16)
    zero_rows = torch.randn(256 * 64 + 5, generator=g, device=dev, dtype=torch.float32)
    zero_rows[256 * 3 : 256 * 4] = 0.0  # an all-zero row: scale 1e-12
    zero_rows[256 * 64 :] = 0.0  # an all-zero ragged tail row
    q_cases["all-zero rows"] = zero_rows
    q_worst = 0.0
    for label, x in q_cases.items():
        q1, s1 = qk.quantize_rows(x)
        q2, s2 = qk.quantize_rows_plain(x)
        torch.cuda.synchronize()
        q_err = int((q1.to(torch.int16) - q2.to(torch.int16)).abs().max())
        s_err = float((s1 - s2).abs().max())
        bits_equal = torch.equal(q1, q2) and torch.equal(s1.view(torch.int32), s2.view(torch.int32))
        q_worst = max(q_worst, q_err, s_err)
        emit("quant_check", case=label, n=x.numel(), dtype=str(x.dtype), equal=bits_equal)
        check(bits_equal, f"quant kernel != plain version on {label}")
    check(float(qk.quantize_rows(zero_rows)[1][3]) == float(torch.tensor(1e-12)), "zero-row scale")

    x = q_cases["1 GiB bf16 chunk"]
    rows = -(-x.numel() // qk.ROW_LEN)
    xdst = torch.empty_like(x)
    q_ms = time_ms(torch, lambda: qk.quantize_rows(x), reps=20)
    q_plain_ms = time_ms(torch, lambda: qk.quantize_rows_plain(x), reps=3, warmup=1)
    q_copy_ms = time_ms(torch, lambda: xdst.copy_(x), reps=20)
    q_bytes = x.numel() * 2 + x.numel() + 4 * rows  # read bf16, write int8 q and f32 scales
    q_bound_ms = q_bytes / bw * 1e3
    del q_cases, x, xdst, zero_rows
    torch.cuda.empty_cache()

    copy_gbps = GIB / (ck_copy_ms * 1e-3) * 2 / 1e9  # a copy reads and writes every byte
    emit(
        "kernel_times",
        checksum={"bytes": GIB, "ms": ck_ms, "plain_ms": ck_plain_ms, "copy_ms": ck_copy_ms,
                  "bound_ms": ck_bound_ms, "achieved_GBps": GIB / (ck_ms * 1e-3) / 1e9},
        quantize_rows={"bytes_moved": q_bytes, "ms": q_ms, "plain_ms": q_plain_ms,
                       "copy_ms": q_copy_ms, "bound_ms": q_bound_ms,
                       "achieved_GBps": q_bytes / (q_ms * 1e-3) / 1e9},
        measured_copy_GBps=copy_gbps,
    )
    return {
        "checksum": dict(
            name="checksum", route="cuda",
            source="src/repro_torch/kernels/csrc/checksum.cu",
            replaces="src/repro/kernels/checksum/kernel.py:47",
            max_abs_err=worst, ms=ck_ms, plain_ms=ck_plain_ms, bound_ms=ck_bound_ms,
            bound_by="bytes", library_ms=None, copy_ms=ck_copy_ms,
            timed_shape="uint8[1073741824] (1 GiB chunk)", matched=True,
            counter=ck.LAUNCHES,
        ),
        "quantize_rows": dict(
            name="quantize_rows", route="cuda",
            source="src/repro_torch/kernels/csrc/quant.cu",
            replaces="src/repro/kernels/quant/kernel.py:30",
            max_abs_err=q_worst, ms=q_ms, plain_ms=q_plain_ms, bound_ms=q_bound_ms,
            bound_by="bytes", library_ms=None, copy_ms=q_copy_ms,
            timed_shape="bfloat16[536870912] (1 GiB chunk)", matched=True,
            counter=qk.LAUNCHES,
        ),
    }


def shape_manifest(torch, glob, shard: int, tp: int):
    """The manifest a TP-``tp`` shard of ``glob`` registers, built from
    shapes alone (meta tensors), and the shard's layout."""
    from repro_torch.core.meta import ShardManifest, build_units
    from repro_torch.resharding import tp_shard
    from repro_torch.transfer.engine import tensor_meta

    local, lay = tp_shard(glob, shard, tp)
    metas = [tensor_meta(n, a, lay[n]) for n, a in local.items()]
    units = build_units(metas)
    return ShardManifest(tensors=tuple(metas), units=tuple(units), checksums=(0,) * len(units)), local, lay


def w_gate_executor(torch, dev, codec: str):
    """The TP-2 destination unit of ``layers/ffn/w_gate`` (the largest
    unit of phase 4, tied with w_up and w_down) as phase 4 plans it from
    the TP-4 source. Planned from shapes alone: the plan of a plain unit
    does not depend on the other tensors."""
    from repro_torch.resharding import ReshardExecutor, layout_from_manifests, plan_shard

    glob = {W_GATE: torch.empty((NUM_LAYERS, 4096, 14336), dtype=torch.bfloat16, device="meta")}
    src = {i: shape_manifest(torch, glob, i, SRC_TP)[0] for i in range(SRC_TP)}
    dst = shape_manifest(torch, glob, 0, DST_TP)[0]
    plan = plan_shard(
        layout_from_manifests(src, SRC_TP), layout_from_manifests({0: dst}, DST_TP), 0,
        num_dest_units=dst.num_units, codec=codec,
    )
    return ReshardExecutor(plan, dst, device=dev)


def byte_err(torch, got, want) -> int:
    """Largest difference between two byte tensors, byte by byte (0 when
    they are bit-equal): the outputs mix dtypes, so bytes are the common
    unit."""
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) if got.numel() else 0


def gather_map(torch, runs, out_nbytes: int, staging_nbytes: int, dev):
    """The per-byte int32 index map the TPU kernel gathers through
    (``build_gather_map``): uncovered bytes point at an appended zero."""
    idx = torch.full((out_nbytes,), staging_nbytes, dtype=torch.int32, device=dev)
    for s_off, d_off, n in runs:
        idx[d_off : d_off + n] = torch.arange(s_off, s_off + n, dtype=torch.int32, device=dev)
    return idx


def reshard_kernel_checks(torch, dev, bw: float) -> dict:
    """Phase 2 for the resharding kernels: the gather and the fused
    dequant+gather held bit-equal to their plain versions, then timed at
    the main path's shape (the TP-2 shard of w_gate with its real runs)."""
    from repro_torch.kernels import repack as rk
    from repro_torch.kernels.quant import fused as fk
    from repro_torch.kernels.quant import quantize_rows_plain
    from repro_torch.transfer.codec import Int8Codec, as_bytes, parse_int8_frame

    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def rand_bytes(n):
        return torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g, device=dev)

    # -- gather_bytes --------------------------------------------------------
    ex = w_gate_executor(torch, dev, "raw")
    unit = ex.manifest.units[0]
    real_runs = ex.instructions(unit.index)
    check(len(real_runs) == SRC_TP * NUM_LAYERS // DST_TP, f"w_gate runs: {len(real_runs)}")
    staging = rand_bytes(ex.staging_bytes(unit.index))
    g_cases = {f"w_gate TP-2 unit, {len(real_runs)} real runs": (staging, real_runs, unit.nbytes)}
    for seed in range(4):
        n = (1 << 20) * (seed + 1) + 7 * seed + 1
        runs = rk.random_runs(seed, n)
        buf = rand_bytes(n + 16)
        g_cases[f"random tiling {seed}, {len(runs)} runs, {n} B"] = (buf, runs, n)
        g_cases[f"random tiling {seed} with gaps"] = (buf, runs[::2], n)
    buf = rand_bytes((1 << 20) + 64)
    for mod in (1, 2, 3):
        for smod, dmod in ((mod, mod), (mod, 0), (0, mod), (mod, 16 - mod)):
            n = (1 << 19) + 5
            runs = [(smod, 64 + dmod, n), (smod + n, dmod, 48)]
            g_cases[f"offsets src {smod} / dst {dmod} mod 16"] = (buf, runs, 64 + dmod + n + 3)
    g_cases["gaps: two runs, 3 B between, 9 B after"] = (buf, [(5, 0, 1000), (1005, 1003, 4000)], 5012)
    g_worst = 0  # largest byte difference, kernel against plain version
    for label, (src, runs, n) in g_cases.items():
        covered = rk.covers([(d, k) for _, d, k in runs], n)
        got = rk.gather_bytes(src, runs, n)
        want = rk.repack_plain(src, runs, n)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        g_worst = max(g_worst, byte_err(torch, got, want))
        emit("gather_check", case=label, nbytes=n, runs=len(runs), covered=covered, equal=equal)
        check(equal, f"gather kernel != plain version on {label}")
    g_ms = time_ms(torch, lambda: rk.gather_bytes(staging, real_runs, unit.nbytes), reps=20)
    g_plain_ms = time_ms(torch, lambda: rk.repack_plain(staging, real_runs, unit.nbytes), reps=10)
    padded = torch.cat([staging, torch.zeros(1, dtype=torch.uint8, device=dev)])
    idx = gather_map(torch, real_runs, unit.nbytes, staging.numel(), dev)
    check(torch.equal(torch.index_select(padded, 0, idx), rk.gather_bytes(staging, real_runs, unit.nbytes)),
          "index_select yardstick != gather kernel")
    g_lib_ms = time_ms(torch, lambda: torch.index_select(padded, 0, idx), reps=10)
    gdst = torch.empty_like(staging)
    g_copy_ms = time_ms(torch, lambda: gdst.copy_(staging), reps=20)
    g_bound_ms = 2 * unit.nbytes / bw * 1e3  # every byte read once and written once
    del g_cases, staging, padded, idx, gdst, buf
    torch.cuda.empty_cache()

    # -- dequant_gather ------------------------------------------------------
    plain_codec = Int8Codec(quantize=quantize_rows_plain)

    def frame(dtype, n, poison=False):
        x = torch.randn(n, generator=g, device=dev, dtype=torch.float32).mul_(2).to(dtype)
        if poison:
            x[n // 2] = float("inf")  # ships as a passthrough frame
        name = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64"}[dtype]
        return parse_int8_frame(plain_codec.encode(x.view(torch.uint8), name))

    def pack(specs):
        """(frame, lead, nbytes, gap) -> placements, 24 bytes uncovered at the end."""
        pos, out = 0, []
        for f, lead, nbytes, gap in specs:
            pos += gap
            out.append((f, lead, nbytes, pos))
            pos += nbytes
        return out, pos + 24

    f_cases = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32, torch.float64):
        isz = torch.empty((), dtype=dtype).element_size()
        ragged = frame(dtype, (1 << 20) + 77)
        f_cases[f"{dtype}: lead/tail trim, ragged last row, passthrough, gap"] = pack([
            (ragged, 256 * isz, ((1 << 20) + 77 - 256 - 100) * isz, 0),
            (frame(dtype, 513), 3 * isz, 510 * isz, 2 * isz),
            (frame(dtype, 300, poison=True), 4 * isz, 200 * isz, 0),
            (ragged, ((1 << 20) + 77 - 90) * isz, 90 * isz, 0),  # the ragged row's tail
        ])
    f_cases["mixed dtypes in one unit, byte-misaligned"] = pack([
        (frame(torch.float64, 600), 8 * 7, 8 * 500, 0),
        (frame(torch.bfloat16, 513), 3, 2 * 400 + 1, 1),
        (frame(torch.float32, 256), 0, 4 * 256, 3),
        (frame(torch.float16, 300, poison=True), 1, 97, 0),
        (frame(torch.float16, 900), 2 * 256, 2 * 644, 0),
    ])
    # the main path's shape: w_gate's TP-2 unit from its TP-4 source's
    # int8 interval frames
    ex8 = w_gate_executor(torch, dev, "int8")
    unit8, placed = next(ex8.unit_batches())
    src_data = [
        torch.randn((NUM_LAYERS, 4096 // SRC_TP, 14336), generator=g, device=dev,
                    dtype=torch.float32).mul_(0.02).to(torch.bfloat16)
        for _ in range(SRC_TP)
    ]
    codec = Int8Codec()
    real = []
    for p in placed:
        iv = p.interval
        view = as_bytes(src_data[iv.source_shard])[iv.read_offset : iv.read_offset + iv.read_nbytes]
        real.append((parse_int8_frame(codec.encode(view, "bfloat16")), iv.lead, iv.nbytes, p.unit_offset))
    del src_data
    main_label = f"w_gate TP-2 unit, {len(real)} real int8 placements"
    f_cases[main_label] = (real, unit8.nbytes)
    f_worst = 0
    for label, (placements, n) in f_cases.items():
        got = fk.fused_repack(placements, n)
        want = fk.fused_repack_plain(placements, n)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        f_worst = max(f_worst, byte_err(torch, got, want))
        emit("dequant_gather_check", case=label, nbytes=n, placements=len(placements), equal=equal)
        check(equal, f"fused dequant+gather kernel != plain version on {label}")
    f_ms = time_ms(torch, lambda: fk.fused_repack(real, unit8.nbytes), reps=20)
    f_plain_ms = time_ms(torch, lambda: fk.fused_repack_plain(real, unit8.nbytes), reps=5, warmup=1)
    fout = fk.fused_repack(real, unit8.nbytes)
    fdst = torch.empty_like(fout)
    f_copy_ms = time_ms(torch, lambda: fdst.copy_(fout), reps=20)
    elems = unit8.nbytes // 2
    f_bytes = elems + 4 * -(-elems // 256) + unit8.nbytes  # q, scales, bf16 output
    f_bound_ms = f_bytes / bw * 1e3
    del f_cases, real, fout, fdst
    torch.cuda.empty_cache()

    emit(
        "reshard_kernel_times",
        gather_bytes={"shape": f"uint8[{unit.nbytes}], {len(real_runs)} runs", "ms": g_ms,
                      "plain_ms": g_plain_ms, "index_select_ms": g_lib_ms, "copy_ms": g_copy_ms,
                      "bound_ms": g_bound_ms,
                      "achieved_GBps": 2 * unit.nbytes / (g_ms * 1e-3) / 1e9},
        dequant_gather={"shape": f"bf16[{elems}] from int8, {len(placed)} placements",
                        "bytes_moved": f_bytes, "ms": f_ms, "plain_ms": f_plain_ms,
                        "copy_ms": f_copy_ms, "bound_ms": f_bound_ms,
                        "achieved_GBps": f_bytes / (f_ms * 1e-3) / 1e9},
    )
    return {
        "gather_bytes": dict(
            name="gather_bytes", route="cuda",
            source="src/repro_torch/kernels/csrc/repack.cu",
            replaces="src/repro/kernels/repack/kernel.py:35",
            max_abs_err=g_worst, ms=g_ms, plain_ms=g_plain_ms, bound_ms=g_bound_ms,
            bound_by="bytes", library_ms=g_lib_ms, copy_ms=g_copy_ms,
            timed_shape=f"uint8[{unit.nbytes}] ({W_GATE} TP-2 unit, {len(real_runs)} runs)",
            matched=True, counter=rk.LAUNCHES,
        ),
        "dequant_gather": dict(
            name="dequant_gather", route="cuda",
            source="src/repro_torch/kernels/csrc/fused.cu",
            replaces="src/repro/kernels/quant/fused.py:159",
            max_abs_err=f_worst, ms=f_ms, plain_ms=f_plain_ms, bound_ms=f_bound_ms,
            bound_by="bytes", library_ms=None, copy_ms=f_copy_ms,
            timed_shape=f"int8 -> bfloat16[{elems}] ({W_GATE} TP-2 unit, {len(placed)} placements)",
            matched=True, counter=fk.LAUNCHES,
        ),
    }


# -- phase 3: the transfer path at full width ----------------------------------


def max_rel_err(torch, got, want) -> float:
    g = got.to(torch.float32)
    w = want.to(torch.float32)
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)


def timed_step(torch, dev, hub, counters, total, steps, label, fn, **tags) -> None:
    """Run one step of a transfer path, ended by a device synchronize;
    record and print its seconds, payload GB/s, bytes per link class and
    kernel launches."""
    torch.cuda.synchronize(dev)
    before = {k: c.value for k, c in counters.items()}
    wire0 = dict(hub.transport.wire_bytes)
    dec0 = dict(hub.transport.decoded_bytes)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    wire = {k: v - wire0.get(k, 0) for k, v in hub.transport.wire_bytes.items() if v - wire0.get(k, 0)}
    dec = {k: v - dec0.get(k, 0) for k, v in hub.transport.decoded_bytes.items() if v - dec0.get(k, 0)}
    launches = {k: c.value - before[k] for k, c in counters.items()}
    rec = dict(seconds=dt, payload_bytes=total, GBps=total / dt / 1e9, wire_bytes=wire,
               decoded_bytes=dec, launches=launches,
               wire_ratio={k: wire[k] / dec[k] for k in wire if dec.get(k)})
    steps[label] = rec
    emit("step", **tags, step=label, **rec)


def transfer(torch, dev, counters, shapes, chunk_bytes) -> dict:
    """Drive publish -> replicate -> update through the client; return the
    kernels' launch counts on that path."""
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.kernels.quant import quantize_rows_plain
    from repro_torch.transfer.codec import DeltaCodec, Int8Codec

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    weights = {
        n: torch.randn(s, generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02) for n, s in shapes
    }
    total = sum(w.nbytes for w in weights.values())
    emit("model", config="llama3-8b", shapes=dict(shapes), dtype="bfloat16", bytes=total)

    torch.cuda.reset_peak_memory_stats(dev)
    server = ReferenceServer()
    hub = TensorHubClient(server, device=dev, chunk_bytes=chunk_bytes)
    trainer = hub.open("m", "trainer", 1, 0, datacenter="dc0")
    trainer.register(weights)
    r0 = hub.open("m", "rollout-0", 1, 0, datacenter="dc0")
    r1 = hub.open("m", "rollout-1", 1, 0, datacenter="dc1")
    r0.register({n: torch.zeros_like(w) for n, w in weights.items()})
    r1.register({n: torch.zeros_like(w) for n, w in weights.items()})
    units = trainer.store.units
    check(any(u.nbytes > chunk_bytes for u in units), "no unit above the chunk threshold")
    check(any(u.is_compact for u in units), "no compact bucket")
    plain_int8 = Int8Codec(quantize=quantize_rows_plain)
    plain_delta = DeltaCodec("int8", quantize=quantize_rows_plain)
    steps = {}

    def step(label, fn):
        timed_step(torch, dev, hub, counters, total, steps, label, fn)

    def r0_equals_trainer():
        for n, w in trainer.store.tensors().items():
            check(torch.equal(r0.store.get(n), w), f"rollout-0 {n} != trainer")

    def rel_err_r1():
        worst = max(max_rel_err(torch, r1.store.get(n), w) for n, w in trainer.store.tensors().items())
        check(worst < 0.01, f"rollout-1 max relative error {worst} >= 1%")
        return worst

    for c in counters.values():
        c.reset()
    step("publish v0", lambda: trainer.publish(0))
    step("replicate rollout-0 (raw)", lambda: r0.replicate(0, timeout=600))
    r0_equals_trainer()
    step("replicate rollout-1 (int8)", lambda: r1.replicate(0, timeout=600))

    def perturb_and_publish():
        trainer.unpublish()
        gp = torch.Generator(device=dev).manual_seed(SEED + 2)
        for w in trainer.store.tensors().values():
            flat = w.view(-1)
            full = flat.numel() // 256 * 256
            rows = flat[:full].view(-1, 256)[::8]  # 1/8 of the 256-element rows, in place
            rows.add_(torch.randn(rows.shape, generator=gp, device=dev, dtype=torch.bfloat16).mul_(0.01))
        trainer.publish(1)

    step("unpublish, perturb 1/8 rows, publish v1", perturb_and_publish)
    step("update rollout-0 (raw)", lambda: check(r0.update("latest"), "rollout-0 not updated"))
    step("update rollout-1 (delta:int8)", lambda: check(r1.update("latest"), "rollout-1 not updated"))
    launches = {k: c.value for k, c in counters.items()}  # the main path's launches, read now
    peak = torch.cuda.max_memory_allocated(dev)

    r0_equals_trainer()
    check(hub.transport.delta_stale_fallbacks == 0, "delta fell back to int8 (stale base)")
    check(server.stats.get("delta_assignments", 0) >= 1, "no delta assignment negotiated")
    i8 = steps["replicate rollout-1 (int8)"]["wire_ratio"].get("vpc_up", 1.0)
    dl = steps["update rollout-1 (delta:int8)"]["wire_ratio"].get("vpc_up", 1.0)
    check(i8 < 0.52, f"int8 wire ratio {i8}")
    check(dl < 0.2, f"delta wire ratio {dl}")
    # rollout-1 against the plain-version codec on the same bytes, unit by
    # unit (chunks are row aligned, so a whole-unit encoding is identical)
    for u in units:
        v1 = trainer.store._gather_unit(u)
        dtype = trainer.store.unit_dtype(u)
        wire = plain_delta.encode(v1, dtype, base=trainer.store.base_unit(u))
        want = plain_delta.decode(wire, base=r1.store.base_unit(u))
        check(torch.equal(r1.store._gather_unit(u), want), f"rollout-1 unit {u.name} != plain delta codec")
        held_v0 = plain_int8.decode(plain_int8.encode(trainer.store.base_unit(u), dtype))
        check(torch.equal(r1.store.base_unit(u), held_v0), f"rollout-1 v0 unit {u.name} != plain int8 codec")
    worst = rel_err_r1()
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the transfer path")
    emit("transfer_result", launches=launches, max_memory_allocated=peak,
         rollout1_max_rel_err=worst, int8_wire_ratio=i8, delta_wire_ratio=dl,
         server_stats={k: v for k, v in server.stats.items() if v})
    return launches


# -- phase 4: resharded transfer at full width --------------------------------


def run_group(handles, fn, timeout: float = 600.0) -> None:
    """One thread per shard, joined with a timeout; the first failure
    re-raised here."""
    errs = []

    def wrap(h):
        try:
            fn(h)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(h,), daemon=True) for h in handles]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    check(not any(t.is_alive() for t in ts), "a shard thread did not finish in time")
    if errs:
        raise errs[0]


def meta_globals(torch, layouts):
    """The trainer's global tensors as meta tensors (shapes only), from
    its per-tensor ``(global_shape, offset)`` layout."""
    return {n: torch.empty(gshape, dtype=torch.bfloat16, device="meta") for n, (gshape, _) in layouts.items()}


def reshard_transfer(torch, dev, counters, shapes, chunk_bytes) -> dict:
    """Drive publish (TP-4) -> resharded replicate (TP-2, raw and int8) ->
    update through the client; return the kernels' launch counts on that
    path."""
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.kernels.quant import quantize_rows_plain
    from repro_torch.resharding import layout_from_manifests, plan_shard, tp_shard
    from repro_torch.transfer.codec import Int8Codec

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    server = ReferenceServer()
    hub = TensorHubClient(server, device=dev, chunk_bytes=chunk_bytes)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = [hub.open("m", "trainer", SRC_TP, i, datacenter="dc0") for i in range(SRC_TP)]
    local = [{} for _ in range(SRC_TP)]
    lay = [{} for _ in range(SRC_TP)]
    for name, shape in shapes:  # one global tensor at a time, cut into owned shards
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02)
        for i in range(SRC_TP):
            part, lay_i = tp_shard({name: w}, i, SRC_TP)
            local[i][name] = part[name].clone()
            lay[i].update(lay_i)
        del w
    for h in trainer:
        h.register(local[h.shard_idx], layout=lay[h.shard_idx])
    del local
    total = sum(t.nbytes for h in trainer for t in h.store.tensors().values())
    emit("model", config="llama3-8b", layers=NUM_LAYERS, dtype="bfloat16", bytes=total,
         trainer_tp=SRC_TP, rollout_tp=DST_TP)
    # host time of the planning each destination shard's pull starts with
    # (layouts from the manifests, then plan_shard), at this layout
    src_manifests = {h.shard_idx: h.store.build_manifest(with_checksums=False) for h in trainer}
    plan_s = {}
    for codec in ("raw", "int8"):
        t0 = time.perf_counter()
        plan = plan_shard(
            layout_from_manifests(src_manifests, SRC_TP),
            layout_from_manifests({0: shape_manifest(torch, meta_globals(torch, lay[0]), 0, DST_TP)[0]}, DST_TP),
            0, codec=codec,
        )
        plan_s[codec] = time.perf_counter() - t0
    emit("plan", seconds_per_dest_shard=plan_s, intervals_per_dest_shard=len(plan.intervals))

    def rollout(name, dc):
        hs = [hub.open("m", name, DST_TP, i, datacenter=dc) for i in range(DST_TP)]
        for h in hs:
            _, metas, lay_i = shape_manifest(torch, meta_globals(torch, lay[0]), h.shard_idx, DST_TP)
            h.register({n: torch.zeros_like(m, device=dev) for n, m in metas.items()}, layout=lay_i)
        return hs

    # roll-int8 pulls first in each step: while the trainer alone holds a
    # version it is the only source, so roll-int8 reshards from it (the
    # server prefers a same-layout source, and a finished roll-raw would be one)
    roll_i8 = rollout("roll-int8", "dc1")
    roll_raw = rollout("roll-raw", "dc0")
    names = [n for n, _ in shapes]
    steps = {}

    def step(label, fn):
        timed_step(torch, dev, hub, counters, total, steps, label, fn, path="phase 4, resharded")

    def trainer_global(name, roundtrip=None):
        """The trainer's tensor assembled from its TP-4 shards; with
        ``roundtrip``, each shard's carrying unit goes through it first."""
        gshape, _ = lay[0][name]
        out = torch.empty(gshape, dtype=torch.bfloat16, device=dev)
        for h in trainer:
            st = h.store
            part = st.get(name)
            if roundtrip is not None:
                u = st.units[st._unit_of[name]]
                dec = roundtrip(st._gather_unit(u), st.unit_dtype(u))
                off = 0 if not u.is_compact else next(o for n, o, _ in u.layout if n == name)
                part = dec[off : off + part.nbytes].view(torch.bfloat16).view(part.shape)
            _, offset = st.layouts[name]
            out[tuple(slice(o, o + d) for o, d in zip(offset, part.shape))] = part
        return out

    plain_int8 = Int8Codec(quantize=quantize_rows_plain)

    def int8_roundtrip(payload, dtype):
        return plain_int8.decode(plain_int8.encode(payload, dtype))

    def check_rollouts(version):
        worst = 0.0
        for name in names:
            want = trainer_global(name)
            want8 = trainer_global(name, int8_roundtrip)
            for i in range(DST_TP):
                ref = tp_shard({name: want}, i, DST_TP)[0][name]
                ref8 = tp_shard({name: want8}, i, DST_TP)[0][name]
                check(torch.equal(roll_raw[i].store.get(name), ref), f"v{version} roll-raw {i} {name} != trainer")
                got8 = roll_i8[i].store.get(name)
                check(torch.equal(got8, ref8), f"v{version} roll-int8 {i} {name} != plain int8 round trip")
                worst = max(worst, max_rel_err(torch, got8, ref))
            del want, want8
        check(worst < 0.01, f"v{version} roll-int8 max relative error {worst} >= 1%")
        for h in roll_raw + roll_i8:
            check(h.intervals_pulled > 0, f"{h.replica}/{h.shard_idx} pulled no interval (not resharded)")
        return worst

    for c in counters.values():
        c.reset()
    step("publish v0 (trainer TP-4)", lambda: run_group(trainer, lambda h: h.publish(0)))
    step("replicate roll-int8 (TP-4 -> TP-2, int8, dc1)",
         lambda: run_group(roll_i8, lambda h: h.replicate(0, timeout=600)))
    step("replicate roll-raw (TP-4 -> TP-2, raw, dc0)",
         lambda: run_group(roll_raw, lambda h: h.replicate(0, timeout=600)))
    launches_v0 = {k: c.value for k, c in counters.items()}
    err_v0 = check_rollouts(0)
    check(launches_v0 == {k: c.value for k, c in counters.items()}, "the checks launched a kernel")

    def perturb_and_publish():
        run_group(trainer, lambda h: h.unpublish())
        gp = torch.Generator(device=dev).manual_seed(SEED + 4)
        for h in trainer:
            for w in h.store.tensors().values():
                flat = w.view(-1)
                full = flat.numel() // 256 * 256
                rows = flat[:full].view(-1, 256)[::8]  # 1/8 of the 256-element rows, in place
                rows.add_(torch.randn(rows.shape, generator=gp, device=dev, dtype=torch.bfloat16).mul_(0.01))
        run_group(trainer, lambda h: h.publish(1))

    step("unpublish, perturb 1/8 rows, publish v1", perturb_and_publish)
    step("update roll-int8 (int8: delta collapses on a reshard)",
         lambda: run_group(roll_i8, lambda h: check(h.update("latest"), "roll-int8 not updated")))
    step("update roll-raw", lambda: run_group(roll_raw, lambda h: check(h.update("latest"), "roll-raw not updated")))
    launches = {k: c.value for k, c in counters.items()}  # the main path's launches, read now
    peak = torch.cuda.max_memory_allocated(dev)
    err_v1 = check_rollouts(1)
    ratios = {label: rec["wire_ratio"].get("vpc_up") for label, rec in steps.items() if "roll-int8" in label}
    for label, r in ratios.items():
        check(r is not None and r < 0.52, f"{label}: WAN wire ratio {r}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the resharded path")
    emit("reshard_result", launches=launches, max_memory_allocated=peak,
         roll_int8_max_rel_err={"v0": err_v0, "v1": err_v1}, int8_wire_ratio=ratios,
         intervals_pulled={f"{h.replica}/{h.shard_idx}": h.intervals_pulled for h in roll_i8 + roll_raw},
         server_stats={k: v for k, v in server.stats.items() if v})
    return launches


# -- phase 5: flash attention and llama3-8b serving at full width -------------

#: tolerances of the flash kernel against its plain version, as
#: tests/test_kernels.py: |got - want| <= tol + tol * |want|
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: tests/test_kernels.py's shapes (b, hq, hkv, sq, sk, d, causal, softcap)
KERNEL_SHAPES = [
    (2, 4, 2, 128, 128, 64, True, 0.0),
    (1, 8, 8, 256, 256, 128, True, 50.0),
    (2, 4, 1, 96, 160, 64, False, 0.0),
    (1, 2, 2, 384, 384, 256, True, 0.0),
    (1, 16, 4, 64, 64, 128, True, 0.0),
    (1, 2, 2, 200, 200, 64, True, 0.0),
]
SERVE_BATCH, PROMPT_LEN, GEN_LEN = 16, 512, 64
BF16_TFLOPS = 989e12  # H100 SXM dense bf16 (the tensor cores' peak)


def live_pairs(sq: int, kv_len: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs a call must score: what this run's data needs."""
    if not causal:
        return sq * kv_len
    return sum(min(kv_len, q_offset + i + 1) for i in range(sq))


def flash_bound_ms(q, k, kv_len: int, causal: bool, q_offset: int, bw: float):
    """The larger of the FLOP time (4 D flops a live pair a query head, at
    the bf16 tensor-core peak) and the byte time (q and o once, the live
    keys of k and v once, at the memory rate)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    flops = 4 * b * hq * d * live_pairs(sq, kv_len, causal, q_offset)
    nbytes = 2 * q.numel() * q.element_size() + 2 * b * hkv * kv_len * d * k.element_size()
    t_ops, t_bytes = flops / BF16_TFLOPS * 1e3, nbytes / bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes"), flops, nbytes


def flash_checks(torch, dev, bw: float) -> dict:
    """Flash attention against its plain version on every route: the
    serving path's prefill (tensor-core route) and decode step at the split
    edges (decode route), a long and an offset prefill, decode at a
    4096-slot cache and tests/test_kernels.py's shapes in f32 and bf16; each
    call must bump its route's counter. Then, at the prefill and decode
    shapes, the route's kernel timed beside the f32 route's kernel on the same
    inputs (the f32 route, called directly), the plain version and
    scaled_dot_product_attention, each with the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 20)

    def qkv(b, hq, hkv, sq, sk, d, dtype):
        return [torch.randn(s, generator=g, device=dev, dtype=torch.float32).to(dtype)
                for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]

    bf16 = torch.bfloat16
    max_len = PROMPT_LEN + GEN_LEN
    prefill = qkv(SERVE_BATCH, 32, 8, PROMPT_LEN, PROMPT_LEN, 128, bf16)
    decode = qkv(SERVE_BATCH, 32, 8, 1, max_len, 128, bf16)
    cases = {"prefill [16,32/8,512,128] bf16 causal": (prefill, dict(causal=True), "bfloat16")}
    for kv_len in (1, 17, 63, 64, 65, 128, 129, 513, 576):
        cases[f"decode [16,32/8,1,128] vs cache 576, kv_len {kv_len}"] = (
            decode, dict(causal=True, q_offset=kv_len - 1, kv_len=kv_len), "bfloat16")
    decode32 = [t.float() for t in decode]
    for kv_len in (1, 65, 576):
        cases[f"decode [16,32/8,1,128] f32 vs cache 576, kv_len {kv_len}"] = (
            decode32, dict(causal=True, q_offset=kv_len - 1, kv_len=kv_len), "float32")
    long_cache = qkv(2, 32, 8, 1, 4096, 128, bf16)
    cases["decode [2,32/8,1,128] vs cache 4096, kv_len 4096"] = (
        long_cache, dict(causal=True, q_offset=4095, kv_len=4096), "bfloat16")
    cases["decode chunk [2,32/8,16,128] at 500 vs cache 576"] = (
        qkv(2, 32, 8, 16, max_len, 128, bf16), dict(causal=True, q_offset=500, kv_len=516), "bfloat16")
    cases["long [1,32/8,4096,128] bf16 causal"] = (qkv(1, 32, 8, 4096, 4096, 128, bf16), dict(causal=True), "bfloat16")
    cases["offset prefill [2,32/8,64,128] at 300 vs cache 576"] = (
        qkv(2, 32, 8, 64, max_len, 128, bf16), dict(causal=True, q_offset=300, kv_len=364), "bfloat16")
    for dtype, name in ((torch.float32, "float32"), (bf16, "bfloat16")):
        for b, hq, hkv, sq, sk, d, causal, cap in KERNEL_SHAPES:
            cases[f"test_kernels [{b},{hq}/{hkv},{sq}x{sk},{d}] causal={causal} softcap={cap} {name}"] = (
                qkv(b, hq, hkv, sq, sk, d, dtype), dict(causal=causal, softcap=cap), name)
    worst_abs, worst_ratio = 0.0, 0.0
    worst_route = {r: 0.0 for r in fa.ROUTES}
    for label, ((q, k, v), kw, dname) in cases.items():
        route = fa._route(q, k)
        before = fa.LAUNCHES.value, fa.ROUTE_LAUNCHES[route].value
        got = fa.flash_attention(q, k, v, **kw).float()
        check((fa.LAUNCHES.value, fa.ROUTE_LAUNCHES[route].value) == (before[0] + 1, before[1] + 1),
              f"flash kernel not launched on its route ({route}) on {label}")
        want = fa.attention_plain(q, k, v, **kw).float()
        torch.cuda.synchronize()
        tol = FLASH_TOL[dname]
        diff = (got - want).abs()
        ratio = float((diff / (tol + tol * want.abs())).max())  # <= 1 passes
        worst_abs = max(worst_abs, float(diff.max()))
        worst_ratio = max(worst_ratio, ratio)
        worst_route[route] = max(worst_route[route], ratio)
        emit("flash_check", case=label, route=route, max_abs_err=float(diff.max()), tol=tol, err_over_tol=ratio)
        check(ratio <= 1.0 and torch.isfinite(got).all().item(), f"flash kernel != plain version on {label} ({route})")
    del cases, got, want, diff, decode32, long_cache
    torch.cuda.empty_cache()

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    # timings at the serving path's shapes (the decode step at a full cache):
    # the route's kernel, the f32 route's kernel on the same inputs,
    # the plain version and SDPA
    times = {}
    for label, route, (q, k, v), kw, sdpa in (
        ("prefill", "tensor_core", prefill, dict(causal=True), lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        ("decode", "decode", decode, dict(causal=True, q_offset=max_len - 1, kv_len=max_len),
         lambda q, k, v: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)),
    ):
        check(fa._route(q, k) == route, f"{label} shape routed to {fa._route(q, k)}")
        calls = {
            "kernel": lambda: fa.flash_attention(q, k, v, **kw),
            "f32_route": lambda: fa.launch_route("f32", q, k, v, **kw),
            "plain": lambda: fa.attention_plain(q, k, v, **kw),
            "sdpa": lambda: sdpa(q, k, v),
        }
        # the device's time a call with the L2 cache cold (the serving path's
        # case), in turns kernel, f32 route, plain, SDPA, kernel; beside it the
        # kernels' device time with the inputs warm in L2 (profiler) and the
        # CUDA-event time of one eager call, host launch included
        cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
        again = cold_ms(torch, calls["kernel"], flush)
        warm = {n: device_ms(torch, f, reps=5 if n == "plain" else 20) for n, f in calls.items()}
        call_ms = {n: time_ms(torch, f, reps=10 if n == "plain" else 30) for n, f in calls.items()}
        out = calls["kernel"]().float()
        lib_err = float((calls["sdpa"]().float() - out).abs().max())
        f32_err = float((calls["f32_route"]().float() - out).abs().max())
        bound, by, flops, nbytes = flash_bound_ms(q, k, kw.get("kv_len", k.shape[2]), True, kw.get("q_offset", 0), bw)
        ms = cold["kernel"]
        times[label] = dict(route=route, shape=f"q {list(q.shape)}, k/v {list(k.shape)} bf16", ms=ms, ms_again=again,
                            f32_route_ms=cold["f32_route"], plain_ms=cold["plain"], sdpa_ms=cold["sdpa"],
                            warm_device_ms=warm, call_ms=call_ms, speedup_over_f32_route=cold["f32_route"] / ms,
                            sdpa_over_kernel=cold["sdpa"] / ms,
                            sdpa_max_abs_diff=lib_err, f32_route_max_abs_diff=f32_err, bound_ms=bound, bound_by=by,
                            flops=flops, bytes=nbytes, achieved_TFLOPs=flops / (ms * 1e-3) / 1e12,
                            achieved_GBps=nbytes / (ms * 1e-3) / 1e9)
    emit("flash_times", **times)
    pre, dec = times["prefill"], times["decode"]
    del prefill, decode, flush
    torch.cuda.empty_cache()
    csrc = "src/repro_torch/kernels/csrc/"
    routes = {
        "tensor_core": dict(source=csrc + "flash_attention_tc.cu", timed_shape=pre["shape"] + " (prefill, causal)",
                            ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
                            bound_by=pre["bound_by"], library_ms=pre["sdpa_ms"], err_over_tol=worst_route["tensor_core"]),
        "decode": dict(source=csrc + "flash_decode.cu", timed_shape=dec["shape"] + " (decode step, kv_len 576)",
                       ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
                       library_ms=dec["sdpa_ms"], err_over_tol=worst_route["decode"]),
        "f32": dict(source=csrc + "flash_attention.cu",
                    timed_shape="the prefill and decode inputs above",
                    ms=pre["f32_route_ms"], decode_ms=dec["f32_route_ms"], plain_ms=pre["plain_ms"],
                    bound_ms=pre["bound_ms"], bound_by=pre["bound_by"], library_ms=pre["sdpa_ms"],
                    err_over_tol=worst_route["f32"]),
    }
    return {
        "flash_attention": dict(
            name="flash_attention", route="cuda",
            source=csrc + "flash_attention_tc.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:96",
            max_abs_err=worst_abs, err_over_tol=worst_ratio,
            ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"], bound_by=pre["bound_by"],
            library_ms=pre["sdpa_ms"], timed_shape=pre["shape"] + " (prefill, causal, tensor_core route)",
            routes=routes, counter=fa.LAUNCHES,
        ),
    }


#: bound on |port - reference| for logits and logprobs at full width in
#: bf16 (see PERF.md): the rollout's prefill/decode (flash kernel, decode
#: matmuls of one token a row) against a teacher-forced forward (plain
#: attention, whole-sequence matmuls) on the same bf16 weights
LOGIT_MAX_ABS, LOGIT_MEAN_ABS = 0.5, 0.05


def device_profile(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and sum the device time
    of its kernels by name: busy seconds (kernels of one stream do not
    overlap), the wall seconds ended by a synchronize, the idle share, and
    the kernels that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    flash_by_name = {n[:60]: t for n, t in by_name.items() if "flash" in n}  # every route's kernels
    flash = sum(flash_by_name.values())
    return dict(wall_seconds=wall, device_busy_seconds=busy,
                idle_share=(1 - busy / wall) if busy else None, flash_seconds=flash,
                flash_share_of_busy=flash / busy if busy else None, flash_kernels=flash_by_name,
                kernels=len(by_name), top=[dict(name=n[:90], seconds=t, share=t / busy) for n, t in top])


def serving(torch, dev, counters, smi: str) -> dict:
    """llama3-8b at its published widths and all 32 layers in bf16,
    served from a TensorHub replica: a trainer (dc0) publishes v0, a
    RolloutWorker (dc0, raw) replicates and answers round 0; the trainer
    perturbs 1/8 of its rows and publishes v1, the worker updates and
    answers round 1 on the same prompts. Returns the kernels' launches on
    that path."""
    from repro_torch.configs.llama3_8b import CONFIG
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.data.synthetic import PromptSet
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES, _route, attention_plain, launch_route
    from repro_torch.models.lm import DecoderLM
    from repro_torch.models.params import init_params
    from repro_torch.rl.loop import RLConfig, RolloutWorker

    cfg = CONFIG
    flash = counters["flash_attention"]
    torch.cuda.reset_peak_memory_stats(dev)
    for c in [*counters.values(), *ROUTE_LAUNCHES.values()]:
        c.reset()
    hub = TensorHubClient(ReferenceServer(), device=dev)
    trainer = hub.open("actor", "trainer", 1, 0, datacenter="dc0")
    t0 = time.perf_counter()
    trainer.register(init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 30), torch.bfloat16, dev))
    weights = trainer.store.tensors()
    nparams = sum(w.numel() for w in weights.values())
    emit("model", config="llama3-8b", layers=cfg.num_layers, dtype="bfloat16", params=nparams,
         bytes=2 * nparams, init_seconds=time.perf_counter() - t0)
    trainer.publish(0)
    rl = RLConfig(model_name="actor", prompt_len=PROMPT_LEN, response_len=GEN_LEN,
                  num_prompts=SERVE_BATCH, group_size=1, seed=SEED)
    served = []  # the worker's out_queue, emptied after each round's checks
    worker = RolloutWorker("rollout-0", hub, rl, cfg, PromptSet(cfg.vocab, PROMPT_LEN, seed=SEED), served,
                           threading.Event(), datacenter="dc0", dtype=torch.bfloat16)
    reference = DecoderLM(cfg, attention=attention_plain)

    def timed(fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    def equal_to_trainer(when):
        for n, w in trainer.store.tensors().items():
            check(torch.equal(worker.params[n], w), f"{when}: rollout {n} != trainer")

    def check_round(rec, version):
        """Logprobs and every step's logits against a teacher-forced
        forward of the whole sequence on the trainer's tensors with the
        plain attention, four sequences at a time."""
        seqs, lps, steps = rec["tokens"], rec["behavior_logprobs"], rec["step_logits"]
        lp_err, logit_max, logit_sum = 0.0, 0.0, 0.0
        for c in range(0, SERVE_BATCH, 4):
            with torch.no_grad():
                ref = reference.forward(trainer.store.tensors(), {"tokens": seqs[c : c + 4]})
            ref = ref[:, PROMPT_LEN - 1 : -1]  # the logits each generated token was drawn from
            lp_ref = torch.log_softmax(ref, -1).gather(-1, seqs[c : c + 4, PROMPT_LEN:, None])[..., 0]
            lp_err = max(lp_err, float((lps[c : c + 4] - lp_ref).abs().max()))
            d = (steps[c : c + 4] - ref).abs()
            logit_max = max(logit_max, float(d.max()))
            logit_sum += float(d.double().sum())
            del ref, lp_ref, d
        logit_mean = logit_sum / steps.numel()
        res = dict(version=version, logprob_max_abs_err=lp_err, logit_max_abs_err=logit_max,
                   logit_mean_abs_err=logit_mean, logit_abs_max=float(steps.abs().max()),
                   all_finite=bool(torch.isfinite(steps).all()), mean_logprob=float(lps.mean()))
        emit("serve_check", **res)
        check(res["all_finite"], f"v{version}: non-finite logits")
        check(lp_err <= LOGIT_MAX_ABS, f"v{version}: logprob error {lp_err} > {LOGIT_MAX_ABS}")
        check(logit_max <= LOGIT_MAX_ABS, f"v{version}: logit error {logit_max} > {LOGIT_MAX_ABS}")
        check(logit_mean <= LOGIT_MEAN_ABS, f"v{version}: mean logit error {logit_mean} > {LOGIT_MEAN_ABS}")
        return res

    _, replicate_s = timed(lambda: worker.connect(timeout=600))
    equal_to_trainer("after replicate")
    rounds, checks = [], []
    for step in range(2):
        if step:
            def perturb_and_publish():
                trainer.unpublish()
                gp = torch.Generator(device=dev).manual_seed(SEED + 31)
                for w in trainer.store.tensors().values():
                    flat = w.view(-1)
                    full = flat.numel() // 256 * 256
                    rows = flat[:full].view(-1, 256)[::8]  # 1/8 of the 256-element rows, in place
                    rows.add_(torch.randn(rows.shape, generator=gp, device=dev, dtype=torch.bfloat16).mul_(0.01))
                trainer.publish(1)

            _, publish_s = timed(perturb_and_publish)
            updated, update_s = timed(worker.pull_latest)
            check(updated and worker.weights_version == 1, "the rollout did not update to v1")
            equal_to_trainer("after update")
        before = {k: c.value for k, c in counters.items()}
        before_route = {r: c.value for r, c in ROUTE_LAUNCHES.items()}
        rec, round_s = timed(lambda: worker.serve_batch(step, keep_logits=True))
        n = flash.value - before["flash_attention"]
        by_route = {r: c.value - before_route[r] for r, c in ROUTE_LAUNCHES.items()}
        want_route = {"decode": cfg.num_layers * GEN_LEN, "tensor_core": cfg.num_layers, "f32": 0}
        check(n == cfg.num_layers * (1 + GEN_LEN), f"round {step}: {n} flash launches, want {cfg.num_layers * (1 + GEN_LEN)}")
        check(by_route == want_route, f"round {step}: flash launches by route {by_route}, want {want_route}")
        check(rec["version"] == step, f"round {step} served v{rec['version']}")
        rounds.append(dict(round=step, version=rec["version"], seconds=round_s, flash_launches=n,
                           flash_launches_by_route=by_route,
                           generated_tokens=SERVE_BATCH * GEN_LEN))
        mid = {k: c.value for k, c in counters.items()}
        checks.append(check_round(rec, step))
        check(mid == {k: c.value for k, c in counters.items()}, "the checks launched a kernel")
        if step == 0:
            first0 = rec["step_logits"][:, 0].clone()  # the prompts' next-token logits under v0
        else:
            delta = float((rec["step_logits"][:, 0] - first0).abs().mean())
            emit("serve_v1_vs_v0", prompt_logits_mean_abs_diff=delta)
            check(delta > 10 * LOGIT_MEAN_ABS, f"round 1 logits barely differ from round 0's ({delta})")
        del rec
        served.clear()
    launches = {k: c.value for k, c in counters.items()}  # the main path's launches, read now
    launches["flash_attention_routes"] = {r: c.value for r, c in ROUTE_LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    # the prefill alone at the same shapes (launches after the read above)
    prompts = torch.from_numpy(worker.prompts.sample(SERVE_BATCH, 1)).to(dev, torch.int64)
    prefill_s = statistics.median(
        timed(lambda: worker.model.prefill(worker.params, {"tokens": prompts}, max_len=PROMPT_LEN + GEN_LEN))[1]
        for _ in range(3)
    )
    r1 = rounds[1]["seconds"]

    # where a round's time goes: the prefill, then a few decode steps, profiled
    n_dec = min(8, GEN_LEN)
    cache = {}

    def prefill():
        cache["state"] = worker.model.prefill(worker.params, {"tokens": prompts}, max_len=PROMPT_LEN + GEN_LEN)

    def decode_steps():
        logits, kv, n = cache["state"]
        for _ in range(n_dec):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            logits, kv = worker.model.decode(worker.params, kv, nxt, n)
            n += 1

    emit("serve_profile", card=smi, prefill=device_profile(torch, prefill),
         decode_steps=n_dec, decode=device_profile(torch, decode_steps))

    # a decode step's wall time with its attention on the decode route and
    # on the f32 route's kernel, in turns on this host: the step is
    # host-bound and hosts differ between runs, so routes compare here only
    def f32_route_attention(q, k, v, **kw):
        return launch_route("f32" if q.shape[2] == 1 else _route(q, k), q, k, v, **kw)

    def step_ms(model):
        logits, kv, n = model.prefill(worker.params, {"tokens": prompts}, max_len=PROMPT_LEN + GEN_LEN)
        times = []
        for _ in range(n_dec):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            (logits, kv), t = timed(lambda: model.decode(worker.params, kv, nxt, n))
            times.append(t * 1e3)
            n += 1
        return statistics.median(times)

    f32_model = DecoderLM(cfg, attention=f32_route_attention)
    steps_ms = {"decode route": step_ms(worker.model), "f32 route": step_ms(f32_model),
                "decode route again": step_ms(worker.model)}
    emit("serve_decode_step", card=smi, layers=cfg.num_layers, median_ms=steps_ms)
    del cache
    emit("serve_result", card=smi, replicate_seconds=replicate_s, publish_v1_seconds=publish_s,
         update_seconds=update_s, rounds=rounds,
         prefill_seconds=prefill_s, prefill_tokens_per_s=SERVE_BATCH * PROMPT_LEN / prefill_s,
         decode_tokens_per_s=SERVE_BATCH * GEN_LEN / (r1 - prefill_s),
         round_tokens_per_s=SERVE_BATCH * GEN_LEN / r1,
         max_memory_allocated=peak, launches=launches, checks=checks)
    check(launches["flash_attention"] == 2 * cfg.num_layers * (1 + GEN_LEN), "flash launches over the two rounds")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    part, bw = memory_rate(name)
    emit("card", torch=torch.__version__, cuda=torch.version.cuda, name=name,
         bound_rate=f"{part} {bw / 1e12} TB/s")
    print(smi, flush=True)

    from repro_torch.core.meta import DEFAULT_CHUNK_BYTES
    from repro_torch.kernels import build
    from repro_torch.models.params import llama3_8b_shapes

    t0 = time.perf_counter()
    so = build.build()
    build.library()
    log = so.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln] if log.exists() else []
    emit("build", seconds=time.perf_counter() - t0, library=str(so.relative_to(ROOT)), ptxas=ptxas)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    phase_s = {}
    t0 = time.perf_counter()
    kernels = kernel_checks(torch, dev, bw)
    kernels.update(reshard_kernel_checks(torch, dev, bw))
    kernels.update(flash_checks(torch, dev, bw))
    phase_s["2 kernels"] = time.perf_counter() - t0
    counters = {k: v.pop("counter") for k, v in kernels.items()}
    shapes = llama3_8b_shapes(num_layers=NUM_LAYERS)
    transfer_counters = {k: c for k, c in counters.items() if k != "flash_attention"}
    t0 = time.perf_counter()
    phase3 = transfer(
        torch, dev, {k: counters[k] for k in ("checksum", "quantize_rows")}, shapes, DEFAULT_CHUNK_BYTES
    )
    gc.collect()  # phase 3's replicas and snapshots go before phase 4 allocates
    torch.cuda.empty_cache()
    phase_s["3 transfer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase4 = reshard_transfer(torch, dev, transfer_counters, shapes, DEFAULT_CHUNK_BYTES)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["4 reshard"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase5 = serving(torch, dev, counters, smi)
    phase_s["5 serving"] = time.perf_counter() - t0
    launches = {k: phase3.get(k, 0) + phase4.get(k, 0) + phase5[k] for k in counters}
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was launched on no main path")
    for r, n in phase5["flash_attention_routes"].items():  # the serving path is the only one with attention
        kernels["flash_attention"]["routes"][r]["launches"] = n
    emit("launches", phase3=phase3, phase4=phase4, phase5=phase5, phase_seconds=phase_s)
    print(json.dumps({"kernels": [dict(v, launches=launches[k]) for k, v in kernels.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
