#!/usr/bin/env python3
"""Where the absorbed-MLA decode kernel's time goes, piece by piece.

Copies of ``csrc/mla_decode.cu`` with one piece of ``mla_decode_kernel``
removed, each built alone (``nvcc -shared`` into
``src/repro_torch/kernels/_build/mla_pieces/<piece>``) and timed in a
process of its own at deepseek-v3's served step (4 x 128 heads, 528 of 528
slots) and a long cache (8192 of 8192 slots): the device time of a call
with the L2 evicted first (``chip_smoke.cold_ms``) and the profiler's time
of each kernel with the inputs warm (the split kernel, then the merge):

    whole        the kernel as it is
    no_p_lo      the P_lo product not issued (one P.V a tile)
    no_s         S = Q.K^T not issued (the softmax sees zeros)
    no_pv        neither P.V product issued
    no_products  no product issued at all
    no_softmax   the online softmax not run (P stays S)
    no_exchange  the warpgroups' barrier at the S exchange removed
    loads        no product, no softmax, no barrier: the loads, the ring
                 and the partials' writes alone
    no_partials  the partials (acc, m, l) not written

Only ``whole`` computes the function; the others' outputs are wrong by
design and only their times count. Each removal is a textual substitution
in the source, and the script stops if the source no longer holds the text
it replaces. A piece that does not finish within ``--timeout`` seconds is
reported and skipped. Run from the repo root on the card:

    python3 tools/mla_decode_pieces.py --rounds 2

It prints the card's name and power limit, one JSON line a piece and round,
then one JSON line of each piece's median times in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

from repro_torch.kernels import build  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = build.BUILD_DIR / "mla_pieces"
#: (name, batch, heads, slots = kv_len)
SHAPES = [("served", 4, 128, 528), ("long_cache", 4, 128, 8192)]


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"mla_decode_pieces: the source no longer holds {old!r}")
    return text.replace(old, new)


def pieces() -> dict:
    """Each piece's source: the kernel's text with one part removed."""
    whole = (SRC / "mla_decode.cu").read_text()
    s_issue = ("      wgmma_ss_n32(sc, sw128_desc(base + kQ + (kk / 4) * kQBox + off, 16, 1024),\n"
               "                   sw128_desc(tl + (kk / 4) * kTBox + off, 16, 1024));\n")
    hi_issue, lo_issue = "      wgmma_rs<256>(o, ph[kk], db);\n", "      wgmma_rs<256>(o, pl[kk], db);\n"
    no_p_lo = _sub(whole, lo_issue, "")
    no_s = _sub(whole, s_issue, "")
    no_pv = _sub(no_p_lo, hi_issue, "")
    no_products = _sub(no_pv, s_issue, "")
    softmax0, softmax_t, ones = "  softmax(0, al_a, al_b);", "    softmax(t, al_a, al_b);", "al_a = al_b = 1.f;"
    no_softmax = _sub(_sub(whole, softmax0, "  " + ones), softmax_t, "    " + ones)
    barrier = "    named_sync(1, kConsumers);\n"
    no_exchange = _sub(whole, barrier, "")
    loads = _sub(_sub(_sub(no_products, softmax0, "  " + ones), softmax_t, "    " + ones), barrier, "")
    no_partials = whole
    for r in "ab":
        no_partials = _sub(no_partials, f"if (live_{r}) *reinterpret_cast<float2*>(acc_{r}",
                           f"if (false) *reinterpret_cast<float2*>(acc_{r}")
    return {"whole": whole, "no_p_lo": no_p_lo, "no_s": no_s, "no_pv": no_pv, "no_products": no_products,
            "no_softmax": no_softmax, "no_exchange": no_exchange, "loads": loads, "no_partials": no_partials}


def build_all(names) -> None:
    """Build each piece's library, all at once (one nvcc a piece)."""
    shutil.rmtree(OUT, ignore_errors=True)
    srcs = pieces()
    procs = {}
    for name in names:
        d = OUT / name
        shutil.copytree(SRC, d)
        (d / "mla_decode.cu").write_text(srcs[name])
        cmd = [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
               str(d), "-o", str(d / "lib.so"), str(d / "mla_decode.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"mla_decode_pieces: nvcc failed for {name}:\n{out[-4000:]}")


def time_piece(name: str, reps: int) -> dict:
    """One piece's cold time and warm time of each kernel at SHAPES (runs in
    a process of its own)."""
    import torch
    from torch.profiler import ProfilerActivity

    from chip_smoke import cold_ms, traced
    from repro_torch.kernels import mla_decode as md

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    lib.th_mla_decode.argtypes = list(build.SIGNATURES["th_mla_decode"])
    lib.th_mla_decode.restype = ctypes.c_int
    build.library = lambda: lib  # the wrapper launches this piece's kernel
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for label, b, h, s in SHAPES:
        qa, qr = (torch.randn((b, h, 1, d), generator=g, device=dev).to(torch.bfloat16) for d in (512, 64))
        ckv, kr = (torch.randn((b, s, d), generator=g, device=dev).to(torch.bfloat16) for d in (512, 64))

        def call():
            return md.mla_decode(qa, qr, ckv, kr, kv_len=s, scale=1.0 / math.sqrt(192))

        call()
        events, _ = traced(torch, lambda: [call() for _ in range(reps)], [ProfilerActivity.CUDA])
        warm = {}
        for e in events:
            key = "merge" if "merge" in e.name else "split"
            warm[key] = warm.get(key, 0.0) + e.time_range.elapsed_us() / reps * 1e-3
        out[label] = dict(cold_ms=cold_ms(torch, call, flush, reps=reps), warm_ms=warm)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2, help="rounds over all pieces, in turns")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=120.0, help="seconds a piece's process may take")
    ap.add_argument("--piece", help=argparse.SUPPRESS)  # time one built piece (the child process)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("mla_decode_pieces: needs a CUDA device", file=sys.stderr)
        return 2
    if args.piece:
        print(json.dumps(dict(piece=args.piece, ms=time_piece(args.piece, args.reps))), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    names = list(pieces())
    build_all(names)
    runs = {n: [] for n in names}
    for r in range(args.rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            try:
                res = subprocess.run([sys.executable, __file__, "--piece", name, "--reps", str(args.reps)],
                                     capture_output=True, text=True, timeout=args.timeout)
            except subprocess.TimeoutExpired:
                print(json.dumps(dict(piece=name, round=r, error=f"no result within {args.timeout} s")), flush=True)
                continue
            line = [ln for ln in res.stdout.splitlines() if ln.startswith('{"piece"')]
            if res.returncode != 0 or not line:
                print(json.dumps(dict(piece=name, round=r, error=res.stderr[-2000:])), flush=True)
                continue
            ms = json.loads(line[-1])["ms"]
            runs[name].append(ms)
            print(json.dumps(dict(piece=name, round=r, ms=ms)), flush=True)
    medians = {}
    for n, ms in runs.items():
        if ms:
            medians[n] = {s[0]: dict(cold_ms=statistics.median(m[s[0]]["cold_ms"] for m in ms),
                                     split_warm_ms=statistics.median(m[s[0]]["warm_ms"]["split"] for m in ms),
                                     merge_warm_ms=statistics.median(m[s[0]]["warm_ms"]["merge"] for m in ms))
                          for s in SHAPES}
    print(json.dumps(dict(card=smi, median_ms=medians)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
