#!/usr/bin/env python3
"""Times the CUDA-core flash kernels of one tree of the port on the card.

The `f32` forward route and the `cuda_core` backward, at the f32 training
shape (q [16, 32, 576, 128], k/v [16, 8, 576, 128], causal), beside
``scaled_dot_product_attention``'s f32 forward and backward on the same
inputs: the device time a call with the L2 cache evicted first
(``cold_ms``) and the profiler's kernel time with the inputs warm
(``warm_ms``), with ``chip_smoke.py``'s helpers. ``--tree`` names the
root of the checkout whose ``src/repro_torch`` is timed (default: this
one), so two commits compare on one card in one call, in turns:

    git archive <parent> | tar -x -C _tree_check/parent
    for t in _tree_check/parent . . _tree_check/parent; do
        python3 tools/flash_cc_ab.py --tree $t; done

Each run builds its tree's kernels into that tree's own ``_build``. It
prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE), help="root of the checkout whose kernels are timed")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--profile", action="store_true",
                    help="also each kernel's device time in the forward and the backward (torch.profiler)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_cc_ab: needs a CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))  # chip_smoke's timing helpers
    import torch.nn.functional as F

    from chip_smoke import F32_TFLOPS, bwd_bound_ms, cold_ms, device_ms, flash_bound_ms, memory_rate
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(tree), fa.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, dout = (torch.randn(s, generator=g, device=dev) for s in
                     ((16, 32, 576, 128), (16, 8, 576, 128), (16, 8, 576, 128), (16, 32, 576, 128)))
    out, lse = fa.launch_route("f32", q, k, v, causal=True, with_lse=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    calls = {
        "f32_route": lambda: fa.launch_route("f32", q, k, v, causal=True),
        "sdpa_forward": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        "cuda_core_backward": lambda: fa.launch_backward(q, k, v, out, lse, dout, causal=True, route="cuda_core"),
        "sdpa_backward": lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True),
    }
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    cold = {n: cold_ms(torch, f, flush, reps=args.reps) for n, f in calls.items()}
    warm = {n: device_ms(torch, f, reps=args.reps) for n, f in calls.items()}
    diff_fwd = float((calls["f32_route"]() - calls["sdpa_forward"]()).abs().max())
    got, ref = calls["cuda_core_backward"](), calls["sdpa_backward"]()
    diff_bwd = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, ref))
    _, bw = memory_rate(torch.cuda.get_device_name(0))
    fwd_bound = flash_bound_ms(q, k, 576, True, 0, bw, peak=F32_TFLOPS)[0]
    bwd_bound = bwd_bound_ms(q, k, 576, True, 0, bw, F32_TFLOPS)[0]
    extra = {}
    if args.profile:
        extra["kernel_ms"] = {n: kernel_times(torch, calls[n], args.reps) for n in ("f32_route", "cuda_core_backward")}
    print(json.dumps(dict(tree=str(args.tree), card=smi, shape="q [16,32,576,128], k/v [16,8,576,128] f32 causal",
                          cold_ms=cold, warm_ms=warm, bound_ms=dict(forward=fwd_bound, backward=bwd_bound),
                          sdpa_max_abs_diff_forward=diff_fwd, sdpa_rel_diff_backward=diff_bwd, **extra)), flush=True)
    return 0


def kernel_times(torch, fn, reps: int) -> dict:
    """Device ms a call of ``fn`` spends in each kernel, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / reps * 1e-3 for e in prof.key_averages() if e.device_time_total > 0}


if __name__ == "__main__":
    sys.exit(main())
