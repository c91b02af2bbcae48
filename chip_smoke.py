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
4. A ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
NUM_LAYERS = 10  # of llama3-8b's 32: three replicas and their delta bases fit one 80 GB card
GIB = 1 << 30
MASK32 = 0xFFFFFFFF


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


# -- phase 3: the transfer path at full width ----------------------------------


def max_rel_err(torch, got, want) -> float:
    g = got.to(torch.float32)
    w = want.to(torch.float32)
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)


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
        emit("step", step=label, **rec)

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

    kernels = kernel_checks(torch, dev, bw)
    counters = {k: v.pop("counter") for k, v in kernels.items()}
    launches = transfer(
        torch, dev, counters, llama3_8b_shapes(num_layers=NUM_LAYERS), DEFAULT_CHUNK_BYTES
    )
    print(json.dumps({"kernels": [dict(v, launches=launches[k]) for k, v in kernels.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
