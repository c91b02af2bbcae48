#!/usr/bin/env python3
"""Where the head_dim-256 attention backwards' time goes, piece by piece.

Copies of ``csrc/flash_attention_bwd_tc.cu`` (the ``tensor_core``
backward) and ``csrc/flash_attention_bwd.cu`` (the ``cuda_core`` one) with
one piece of their head_dim-256 kernels removed, each built alone (``nvcc
-shared`` into ``<tree>/src/repro_torch/kernels/_build/bwd256_pieces/<route>-<piece>``)
and timed in a process of its own where the main path launches them
(``tensor_core``: phase 10's [4, 8/4, 576, 256] bf16; ``cuda_core``: phase
7's [2, 8/4, 512, 256] f32; both causal, softcap 50, window 4096) and at
4672 rows ([2, 8/4, 4672, 256]); ``tensor_core`` also at phase 12's
(192, 128) plan of the same kernel (q/k [4, 128, 576, 192], v [4, 128,
576, 128] bf16, causal):

    whole        the kernels as they are
    no_pds       P and dS not formed from the scores (the softcap, the
                 exponential, the masks, dS's arithmetic)
    no_handover  the barriers that hand scores, P or dS between the
                 threads of a block removed
    no_store     the gradients not written to device memory
    no_products  no product issued: the loads, the softmax, the hand-overs
                 and the stores alone

Only ``whole`` computes the gradients; the others' outputs are wrong by
design and only their times count. Each piece reports the device time of a
whole backward call with the L2 evicted first (``chip_smoke.cold_ms``) and
each kernel's time in a profiler trace of such calls, cold (a fill of the
L2 before every call) and warm (calls back to back). Each removal is a
textual substitution in the source, and the script stops if the source no
longer holds the text it replaces. A piece that does not finish within
``--timeout`` seconds is reported and skipped. ``--tree`` names the root of
the checkout whose sources are cut (default: this one). Run from the repo
root on the card:

    python3 tools/flash_bwd256_pieces.py --rounds 2

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

HERE = Path(__file__).resolve().parent.parent

#: route -> (source file, (label, batch, sq, dtype name)); 8/4 heads of
#: 256, causal, softcap 50, window 4096, but for the MLA shape
ROUTES = {
    "tensor_core": ("flash_attention_bwd_tc.cu", (("phase10", 4, 576, "bfloat16"), ("rows4672", 2, 4672, "bfloat16"),
                                                  ("phase12_mla", 4, 576, "bfloat16"))),
    "cuda_core": ("flash_attention_bwd.cu", (("phase7", 2, 512, "float32"), ("rows4672", 2, 4672, "float32"))),
}
KW = dict(causal=True, softcap=50.0, window=4096)
#: the MLA shape's heads (each of its own K/V), (q/k, v) widths and call
MLA = dict(hq=128, hkv=128, d=192, dv=128, kw=dict(causal=True))
PIECES = ("whole", "no_pds", "no_handover", "no_store", "no_products")


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"flash_bwd256_pieces: the source no longer holds {old!r}")
    return text.replace(old, new)


def _subs(text: str, pairs) -> str:
    for old, new in pairs:
        text = _sub(text, old, new)
    return text


#: the head_dim-256 part of each source starts at this text
SECTION = "// -- 4. head_dim 256"

#: route -> piece -> (old, new) substitutions in the head_dim-256 part, and
#: text put before that part (helpers the substitutions call)
CUTS = {
    "tensor_core": {
        "no_pds": [("softmax_p(0, s);", "if (p.sq < 0) softmax_p(0, s);"),
                   ("softmax_p(i + 1, s1);", "if (p.sq < 0) softmax_p(i + 1, s1);"),
                   ("softmax_ds(s);", "if (p.sq < 0) softmax_ds(s);"),
                   ("softmax_ds(s1);", "if (p.sq < 0) softmax_ds(s1);")],
        "no_handover": [("consumers_sync(kBarFree);", "if (p.sq < 0) consumers_sync(kBarFree);"),
                        ("consumers_sync(kBarFull);", "if (p.sq < 0) consumers_sync(kBarFull);")],
        "no_store": [("store_row<", "if (p.sq < 0) store_row<")],
        "no_products": [("wgmma_ss_n32(sc,", "skip_wgmma(sc,"), ("wgmma_ss_n32(dp,", "skip_wgmma(dp,"),
                        ("wgmma_ss_tb_n128(", "skip_wgmma("), ("wgmma_ss_tb_n64(", "skip_wgmma("),
                        ("wgmma_ss_tb_n32(", "skip_wgmma(")],
    },
    "cuda_core": {
        "no_pds": [("if (p.softcap > 0.f) sv = p.softcap * tanhf(sv / p.softcap);", ""),
                   ("p_and_factor(sv, lse, inv_cap, ok)", "make_float2(sv, sv)")],
        "no_handover": [("__syncthreads();  // the partial sums are in", ""),
                        ("__syncthreads();  // the other's values are in", "")],
        "no_store": [("store_n<4>(", "if (p.sq < 0) store_n<4>(")],
        "no_products": [("slab_scores<T>(s,", "if (p.sq < 0) slab_scores<T>(s,"),
                        ("slab_accumulate<T, kSub>(", "if (p.sq < 0) slab_accumulate<T, kSub>("),
                        ("slab_accumulate<T, kSub / 2>(", "if (p.sq < 0) slab_accumulate<T, kSub / 2>(")],
    },
}
HELPERS = ("template <typename... A>\n__device__ __forceinline__ void skip_wgmma(A&&...) {}\n\n")


def pieces(tree: Path, route: str) -> dict:
    """Each piece's source: the route's file with one part of its
    head_dim-256 kernels removed."""
    text = (tree / "src/repro_torch/kernels/csrc" / ROUTES[route][0]).read_text()
    cut = text.index(SECTION)
    head, body = text[:cut], text[cut:]
    out = {"whole": text}
    for piece, pairs in CUTS[route].items():
        out[piece] = head + HELPERS + _subs(body, pairs)
    return out


def out_dir(tree: Path) -> Path:
    return tree / "src/repro_torch/kernels/_build/bwd256_pieces"


def build_all(tree: Path) -> None:
    """Build each piece's library, all at once (one nvcc a piece)."""
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import build

    csrc = tree / "src/repro_torch/kernels/csrc"
    shutil.rmtree(out_dir(tree), ignore_errors=True)
    procs = {}
    for route, (fname, _) in ROUTES.items():
        for name, src in pieces(tree, route).items():
            d = out_dir(tree) / f"{route}-{name}"
            shutil.copytree(csrc, d)
            (d / fname).write_text(src)
            cmd = [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
                   str(d), "-o", str(d / "lib.so"), str(d / fname)]
            procs[f"{route}-{name}"] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                        text=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"flash_bwd256_pieces: nvcc failed for {name}:\n{out[-4000:]}")


def time_piece(tree: Path, route: str, name: str, reps: int) -> dict:
    """One piece's times at its route's shapes (runs in a process of its
    own): the call's cold time and each kernel's, cold and warm."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    from chip_smoke import cold_ms, kernel_split_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    lib = ctypes.CDLL(str(out_dir(tree) / f"{route}-{name}" / "lib.so"))
    for sym, argtypes in build.SIGNATURES.items():
        fn = getattr(lib, sym, None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    build.library = lambda: lib  # the wrapper launches this piece's kernels
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    res = {}
    for label, b, s, dname in ROUTES[route][1]:
        dtype = getattr(torch, dname)
        shape = MLA if label.endswith("mla") else dict(hq=8, hkv=4, d=256, dv=256, kw=KW)
        kw = shape["kw"]
        q = torch.randn((b, shape["hq"], s, shape["d"]), generator=g, device=dev).to(dtype)
        k = torch.randn((b, shape["hkv"], s, shape["d"]), generator=g, device=dev).to(dtype)
        v = torch.randn((b, shape["hkv"], s, shape["dv"]), generator=g, device=dev).to(dtype)
        dout = torch.randn((b, shape["hq"], s, shape["dv"]), generator=g, device=dev).to(dtype)
        o = fa.attention_plain(q, k, v, **kw)  # the plain forward: the piece's library holds no forward
        lse = fa.attention_lse_plain(q, k, **kw)

        def call():
            return fa.launch_backward(q, k, v, o, lse, dout, route=route, **kw)

        n = max(3, reps // 4) if s > 1024 else reps
        res[label] = dict(call_cold_ms=cold_ms(torch, call, flush, reps=n),
                          kernels_ms=kernel_split_ms(torch, call, flush, n))
        del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE), help="root of the checkout whose sources are cut")
    ap.add_argument("--rounds", type=int, default=2, help="rounds over all pieces, in turns")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=240.0, help="seconds a piece's process may take")
    ap.add_argument("--piece", help=argparse.SUPPRESS)  # time one built piece (the child process)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd256_pieces: needs a CUDA device", file=sys.stderr)
        return 2
    if args.piece:
        route, name = args.piece.split("-", 1)
        print(json.dumps(dict(piece=args.piece, ms=time_piece(tree, route, name, args.reps))), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build_all(tree)
    names = [f"{r}-{p}" for r in ROUTES for p in PIECES]
    runs = {n: [] for n in names}
    for r in range(args.rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            cmd = [sys.executable, __file__, "--tree", str(tree), "--piece", name, "--reps", str(args.reps)]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
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
    medians = {n: {label: statistics.median(m[label]["call_cold_ms"] for m in ms) for label in ms[0]}
               for n, ms in runs.items() if ms}
    print(json.dumps(dict(card=smi, median_call_cold_ms=medians)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
