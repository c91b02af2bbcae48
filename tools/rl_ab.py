#!/usr/bin/env python3
"""Times the GRPO step of ``chip_smoke.py``'s RL loop (phase 6: llama3-8b at
4 layers; phase 10: gemma2-2b at 26) for one tree of the port on the card.

Runs that tree's own ``chip_smoke.rl_loop`` (phase 6) or
``gemma2_rl_loop`` (phase 10), with its checks, and prints the card's
name and power limit, then one JSON line with the step's seconds and
training tokens/s, the profiled second step's wall and device-busy
seconds and its elementwise share, and the peak memory. The step's host
time drifts between chip calls, so compare two commits only in turns in
one call:

    git archive <parent> | tar -x -C _tree_check/parent
    for t in _tree_check/parent . . _tree_check/parent; do
        python3 tools/rl_ab.py --tree $t --phase 10; done

Each tree builds its kernels into its own ``_build`` on first use.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE), help="root of the checkout whose RL loop is timed")
    ap.add_argument("--phase", type=int, choices=(6, 10), default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("rl_ab: needs a CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import flash_attention as fa

    assert Path(chip_smoke.__file__).resolve().is_relative_to(tree), chip_smoke.__file__
    assert Path(fa.__file__).resolve().is_relative_to(tree), fa.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main
    counters = {"flash_attention": fa.LAUNCHES, "checksum": ck.LAUNCHES}
    run = chip_smoke.gemma2_rl_loop if args.phase == 10 else chip_smoke.rl_loop
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(torch, dev, counters, smi)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    res = next(ln for ln in lines if ln.get("phase") == "rl_result")
    prof = next(ln for ln in lines if ln.get("phase") == "train_profile")["step"]
    print(json.dumps(dict(tree=str(args.tree), phase=args.phase, card=smi, step_s=res["train_step_seconds"],
                          training_tokens_per_s=res["training_tokens_per_s"],
                          profiled_wall_s=prof["wall_seconds"], profiled_busy_s=prof["device_busy_seconds"],
                          elementwise_share=prof["by_class"].get("elementwise", {}).get("share"),
                          peak_bytes=res["max_memory_allocated"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
