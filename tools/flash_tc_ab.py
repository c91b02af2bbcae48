#!/usr/bin/env python3
"""Times the tensor-core flash forward of one tree of the port on the card.

The ``tensor_core`` route at the shapes its plans serve: deepseek-v3's
expanded MLA prefill (q/k [4, 128, 512, 192], v [4, 128, 512, 128],
causal; phase 12), gemma2-2b's prefill (q [4, 8, 4608, 256], k/v [4, 4,
4608, 256], softcap 50, window 4096 and global; phase 9), gemma2's
training forward with the log-sum-exp ([4, 8, 576, 256], k/v 4 heads,
window 4096, softcap 50; phase 10) and llama3-8b's prefill (q [16, 32, 512,
128], k/v 8 heads, causal; phase 5): the device time a call with the L2
cache evicted first (``cold_ms``) and the profiler's kernel time with the
inputs warm (``warm_ms``), with ``chip_smoke.py``'s helpers, beside each
shape's bound and, where one PyTorch call computes the same function,
``scaled_dot_product_attention`` (MLA and llama3-8b). ``--tree`` names the
root of the checkout whose ``src/repro_torch`` is timed (default: this
one), so two commits compare on one card in one call, in turns:

    git archive <parent> | tar -x -C _tree_check/parent
    for t in _tree_check/parent . . _tree_check/parent; do
        python3 tools/flash_tc_ab.py --tree $t; done

Each run builds its tree's kernels into that tree's own ``_build`` and
checks each shape against the plain version (bf16 tolerance). It prints
the card's name and power limit, the ptxas lines of the tree's
tensor-core forward kernels, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

#: (name, q shape, k shape, v head_dim, keyword arguments, with_lse)
SHAPES = [
    ("mla_prefill", (4, 128, 512, 192), (4, 128, 512, 192), 128, dict(causal=True), False),
    ("gemma2_prefill_window", (4, 8, 4608, 256), (4, 4, 4608, 256), 256,
     dict(causal=True, softcap=50.0, window=4096), False),
    ("gemma2_prefill_global", (4, 8, 4608, 256), (4, 4, 4608, 256), 256, dict(causal=True, softcap=50.0), False),
    ("gemma2_training_forward", (4, 8, 576, 256), (4, 4, 576, 256), 256,
     dict(causal=True, softcap=50.0, window=4096), True),
    ("llama3_prefill", (16, 32, 512, 128), (16, 8, 512, 128), 128, dict(causal=True), False),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE), help="root of the checkout whose kernels are timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_tc_ab: needs a CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))  # chip_smoke's timing helpers
    import torch.nn.functional as F

    from chip_smoke import FLASH_TOL, cold_ms, device_ms, flash_bound_ms, memory_rate, mla_bound_ms, ptxas_lines
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(tree), fa.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    so = build.build()
    build.library()
    log = so.with_suffix(".log")
    tc = log.read_text().split("== flash_attention_tc.cu", 1)[-1].split("\n== ", 1)[0] if log.exists() else ""
    for line in ptxas_lines(tc):
        print("ptxas", line, flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(23)
    _, bw = memory_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for name, qs, ks, dv, kw, with_lse in SHAPES:
        q, k = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16) for s in (qs, ks))
        v = torch.randn(ks[:3] + (dv,), generator=g, device=dev).to(torch.bfloat16)
        calls = {"kernel": lambda: fa.launch_route("tensor_core", q, k, v, with_lse=with_lse, **kw)}
        if not kw.get("softcap") and not kw.get("window"):
            group = qs[1] // ks[1]
            calls["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=group > 1)
        cold = {n: cold_ms(torch, f, flush, reps=args.reps) for n, f in calls.items()}
        warm = {n: device_ms(torch, f, reps=args.reps) for n, f in calls.items()}
        got = calls["kernel"]()
        got = got[0] if with_lse else got
        want = fa.attention_plain(q, k, v, **kw).float()
        tol = FLASH_TOL["bfloat16"]
        ratio = float(((got.float() - want).abs() / (tol + tol * want.abs())).max())
        if dv == qs[3]:
            bound, by = flash_bound_ms(q, k, ks[2], True, 0, bw, window=kw.get("window", 0))[:2]
        else:
            bound, by = mla_bound_ms(qs[0], qs[1], ks[1], qs[2], ks[2], True, 0, bw)[:2]
        out[name] = dict(q=list(qs), k=list(ks), v_head_dim=dv, kw=kw, with_lse=with_lse, cold_ms=cold, warm_ms=warm,
                         bound_ms=bound, bound_by=by, bound_share=bound / cold["kernel"], err_over_tol=ratio)
        if ratio > 1.0:
            print(f"flash_tc_ab: {name}: kernel != plain version ({ratio:.3f} of the tolerance)", file=sys.stderr)
            return 1
        del q, k, v, got, want, calls
        torch.cuda.empty_cache()
    print(json.dumps(dict(tree=str(args.tree), card=smi, shapes=out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
