#!/usr/bin/env python3
"""Where the wide tensor-core forward's time goes, piece by piece.

Copies of ``csrc/flash_attention_tc.cu`` with one piece of
``flash_tc_wide_kernel`` removed, each built alone (``nvcc -shared`` into
``src/repro_torch/kernels/_build/pieces/<piece>``) and timed, with the L2
evicted first (``chip_smoke.cold_ms``), in a process of its own at MLA's
prefill (q/k [4,128,512,192], v 128, causal) and gemma2's windowed prefill
(q [4,8,4608,256], k/v 4 heads, window 4096) with softcap 50 and without:

    whole        the kernel as it is
    no_products  the products (S = Q.K^T and P.V) not issued
    no_softmax   the softmax not run
    loads        neither: the loads, the turns and the output alone
    no_store     the output not written to device memory
    exact_max    the running max kept exact (kSlack 0): O rescaled at every
                 new row max

Only ``whole`` and ``exact_max`` compute attention; the others' outputs are
wrong by design and only their times count. Each removal is a textual
substitution in the source, and the script stops if the source no longer
holds the text it replaces. A piece that does not finish within
``--timeout`` seconds is reported and skipped. Run from the repo root on
the card:

    python3 tools/flash_tc_pieces.py --rounds 2

It prints the card's name and power limit, one JSON line a piece and round,
then one JSON line of each piece's median times in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
OUT = build.BUILD_DIR / "pieces"
SHAPES = [
    ("mla_prefill", (4, 128, 512, 192), (4, 128, 512, 192), 128, dict(causal=True)),
    ("gemma2_window", (4, 8, 4608, 256), (4, 4, 4608, 256), 256, dict(causal=True, softcap=50.0, window=4096)),
    ("gemma2_window_softcap_0", (4, 8, 4608, 256), (4, 4, 4608, 256), 256, dict(causal=True, window=4096)),
]


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"flash_tc_pieces: the source no longer holds {old!r}")
    return text.replace(old, new)


def pieces() -> dict:
    """Each piece's source: the wide kernel's text with one part removed."""
    text = (SRC / "flash_attention_tc.cu").read_text()
    cut = text.index("flash_tc_wide_kernel(const")
    head, body = text[:cut], text[cut:]
    s_issue, pv_issue = "        wgmma_ss_n64(sc, da, db);", "        wgmma_rs<DV>(o, pa[kk],"
    no_products = _sub(_sub(body, s_issue, "        if (p.sq < 0) wgmma_ss_n64(sc, da, db);"),
                       pv_issue, "        if (p.sq < 0) wgmma_rs<DV>(o, pa[kk],")
    no_softmax = _sub(_sub(body, "      softmax(lo);\n", ""), "        softmax(i);\n", "")
    loads = _sub(_sub(no_softmax, s_issue, "        if (p.sq < 0) wgmma_ss_n64(sc, da, db);"),
                 pv_issue, "        if (p.sq < 0) wgmma_rs<DV>(o, pa[kk],")
    no_store = _sub(body, "for (int nb = 0; nb < NBV; ++nb) tma_store(",
                    "for (int nb = 0; nb < (p.sq < 0 ? NBV : 0); ++nb) tma_store(")
    exact = _sub(head, "constexpr float kSlack = 8.f;", "constexpr float kSlack = 0.f;")
    return {"whole": head + body, "no_products": head + no_products, "no_softmax": head + no_softmax,
            "loads": head + loads, "no_store": head + no_store, "exact_max": exact + body}


def build_all(names) -> None:
    """Build each piece's library, all at once (one nvcc a piece)."""
    shutil.rmtree(OUT, ignore_errors=True)
    srcs = pieces()
    procs = {}
    for name in names:
        d = OUT / name
        shutil.copytree(SRC, d)
        (d / "flash_attention_tc.cu").write_text(srcs[name])
        cmd = [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
               str(d), "-o", str(d / "lib.so"), str(d / "flash_attention_tc.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"flash_tc_pieces: nvcc failed for {name}:\n{out[-4000:]}")


def time_piece(name: str, reps: int) -> dict:
    """One piece's cold times at SHAPES (runs in a process of its own)."""
    import torch

    from chip_smoke import cold_ms
    from repro_torch.kernels import flash_attention as fa

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    lib.th_flash_attention_tc.argtypes = list(build.SIGNATURES["th_flash_attention_tc"])
    lib.th_flash_attention_tc.restype = ctypes.c_int
    build.library = lambda: lib  # the wrapper launches this piece's kernel
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    ms = {}
    for label, qs, ks, dv, kw in SHAPES:
        q, k = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16) for s in (qs, ks))
        v = torch.randn(ks[:3] + (dv,), generator=g, device=dev).to(torch.bfloat16)
        ms[label] = cold_ms(torch, lambda: fa.launch_route("tensor_core", q, k, v, **kw), flush, reps=reps)
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2, help="rounds over all pieces, in turns")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=120.0, help="seconds a piece's process may take")
    ap.add_argument("--piece", help=argparse.SUPPRESS)  # time one built piece (the child process)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_tc_pieces: needs a CUDA device", file=sys.stderr)
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
    medians = {n: {s[0]: statistics.median(m[s[0]] for m in ms) for s in SHAPES} for n, ms in runs.items() if ms}
    print(json.dumps(dict(card=smi, median_ms=medians)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
