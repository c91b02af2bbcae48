#!/usr/bin/env python3
"""Times the head_dim-256 attention backwards of one tree of the port on the card.

Both backward routes at gemma2's head_dim 256 (8 query and 4 KV heads,
causal, softcap 50, window 4096), where the main path launches them and at
gemma2's full 4608 + 64 rows: the ``tensor_core`` route in bf16 at phase
10's [4, 8/4, 576, 256] and at [2, 8/4, 4672, 256]; the ``cuda_core`` route
in f32 at phase 7's [2, 8/4, 512, 256] and at [2, 8/4, 4672, 256]. For each:
the device time of a call with the L2 cache evicted first (``cold_ms``),
the profiler's time of a call with the inputs warm (``warm_ms``), each
kernel's time (``kernels_ms``, cold and warm), the plain backward's cold
time, SDPA's backward on the same shape without the softcap (K/V repeated
to the query heads; ``is_causal`` where the window does not bite, else the
window as a boolean mask; its forward out of the timing) and the bound at
the inputs' peak, with ``chip_smoke.py``'s helpers. Each shape is checked
against ``attention_backward_plain`` within ``FLASH_TOL``. ``--tree`` names
the root of the checkout whose ``src/repro_torch`` is timed (default: this
one), so two commits compare on one card in one call, in turns:

    git archive <parent> | tar -x -C _tree_check/parent
    for t in _tree_check/parent . . _tree_check/parent; do
        python3 tools/flash_bwd256_ab.py --tree $t; done

Each run builds its tree's kernels into that tree's own ``_build``. It
prints the card's name and power limit, the ptxas lines of the tree's
head_dim-256 backward kernels, a digest of every other kernel's ptxas
register and spill lines (equal digests: those kernels compiled as the
other tree's), the HGMMA and UTMALDG instructions in the head_dim-256
backward kernels' SASS (``cuobjdump``), one JSON line a shape, then one
JSON line of all.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

#: (name, route, batch, rows, dtype name)
SHAPES = [
    ("tensor_core phase 10", "tensor_core", 4, 576, "bfloat16"),
    ("tensor_core 4672 rows", "tensor_core", 2, 4672, "bfloat16"),
    ("cuda_core phase 7", "cuda_core", 2, 512, "float32"),
    ("cuda_core 4672 rows", "cuda_core", 2, 4672, "float32"),
]
WINDOW, SOFTCAP = 4096, 50.0
#: the head_dim-256 backward kernels of any tree (the ones a redesign
#: changes, the pre kernels' 256 instances among them); every other
#: kernel's lines go into the digest
BWD256 = re.compile(r"flash_bwd_\w*256_kernel|flash_bwd_\w*pre_kernel<(\w+, )?256>")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE), help="root of the checkout whose kernels are timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd256_ab: needs a CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))  # chip_smoke's timing helpers
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from chip_smoke import (BF16_TFLOPS, F32_TFLOPS, FLASH_TOL, bwd_bound_ms, cold_ms, device_ms, grad_err,
                            kernel_split_ms, memory_rate, ptxas_lines, sass_counts, sdpa_backend)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(tree), fa.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    so = build.build()
    build.library()
    log = so.with_suffix(".log")
    lines = [ln for ln in ptxas_lines(log.read_text() if log.exists() else "")
             if "Used " in ln or "stack frame" in ln]
    mine = [ln for ln in lines if BWD256.search(ln.split(" | ")[0])]
    others = sorted(ln for ln in lines if ln not in mine)
    for ln in mine:
        print("ptxas", ln, flush=True)
    print("ptxas_others", json.dumps(dict(lines=len(others), sha256=hashlib.sha256("\n".join(others).encode())
                                          .hexdigest())), flush=True)
    print("sass", json.dumps({f: c for f, c in sass_counts(so, "flash_bwd").items() if BWD256.search(f)}), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(25)
    _, bw = memory_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    kw = dict(causal=True, softcap=SOFTCAP, window=WINDOW)
    out = {}
    for name, route, b, s, dname in SHAPES:
        dtype = getattr(torch, dname)
        q = torch.randn((b, 8, s, 256), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((b, 4, s, 256), generator=g, device=dev).to(dtype) for _ in range(2))
        dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        o, lse = fa.launch_route(fa._route(q, k, grad=True), q, k, v, with_lse=True, **kw)
        sq_, sk_, sv_ = (t.clone().requires_grad_() for t in (q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)))
        if s <= WINDOW:
            sdpa_kw = dict(is_causal=True)
        else:
            pos = torch.arange(s, device=dev)
            sdpa_kw = dict(attn_mask=(pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - WINDOW))
        backend = sdpa_backend(torch, lambda: F.scaled_dot_product_attention(sq_, sk_, sv_, **sdpa_kw))
        with sdpa_kernel([backend]):
            sdpa_out = F.scaled_dot_product_attention(sq_, sk_, sv_, **sdpa_kw)
        calls = {"kernel": lambda: fa.launch_backward(q, k, v, o, lse, dout, route=route, **kw),
                 "plain": lambda: fa.attention_backward_plain(q, k, v, o, lse, dout, **kw),
                 "sdpa": lambda: torch.autograd.grad(sdpa_out, (sq_, sk_, sv_), dout, retain_graph=True)}
        reps = args.reps if s <= 1024 else max(3, args.reps // 4)
        cold = {n: cold_ms(torch, f, flush, reps=3 if n == "plain" else reps) for n, f in calls.items()}
        warm = {n: device_ms(torch, calls[n], reps=reps) for n in ("kernel", "sdpa")}
        split = kernel_split_ms(torch, calls["kernel"], flush, reps=reps)
        got, want = calls["kernel"](), calls["plain"]()
        errs = {n: grad_err(torch, a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
        peak = F32_TFLOPS if dtype == torch.float32 else BF16_TFLOPS
        bound, by, flops, nbytes = bwd_bound_ms(q, k, s, True, 0, bw, peak, window=WINDOW)
        out[name] = dict(q=list(q.shape), k=list(k.shape), dtype=dname, cold_ms=cold, warm_ms=warm, kernels_ms=split,
                         library=str(backend), library_kw=sorted(sdpa_kw), bound_ms=bound, bound_by=by,
                         bound_share=bound / cold["kernel"], rel_err=errs, tol=FLASH_TOL[dname])
        print(json.dumps({name: out[name]}), flush=True)
        if max(errs.values()) > FLASH_TOL[dname]:
            print(f"flash_bwd256_ab: {name}: kernels != plain backward ({errs})", file=sys.stderr)
            return 1
        del q, k, v, dout, o, lse, sq_, sk_, sv_, sdpa_out, calls, got, want
        torch.cuda.empty_cache()
    print(json.dumps(dict(tree=str(args.tree), card=smi, shapes=out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
