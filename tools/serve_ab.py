#!/usr/bin/env python3
"""Times phase 5 of ``chip_smoke.py`` (llama3-8b served at all 32 layers)
for one tree of the port on the card.

Runs that tree's own ``chip_smoke.serving`` (two rounds of 16 x (512 +
64) from a replica, with its checks) and prints the card's name and power
limit, then one JSON line with the rounds' seconds, the prefill and
decode tokens/s and the per-step decode medians. Decode is host-bound and
the host's speed drifts between chip calls, so compare two commits only
in turns in one call:

    git archive <parent> | tar -x -C _tree_check/parent
    for i in 1 2 3 4 5; do for t in _tree_check/parent .; do
        python3 tools/serve_ab.py --tree $t; done; done

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
    ap.add_argument("--tree", default=str(HERE), help="root of the checkout whose serving path is timed")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("serve_ab: needs a CUDA device", file=sys.stderr)
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
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        chip_smoke.serving(torch, dev, {"flash_attention": fa.LAUNCHES, "checksum": ck.LAUNCHES}, smi)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    res = next(ln for ln in lines if ln.get("phase") == "serve_result")
    step = next(ln for ln in lines if ln.get("phase") == "serve_decode_step")
    print(json.dumps(dict(tree=str(args.tree), card=smi, rounds_s=[r["seconds"] for r in res["rounds"]],
                          prefill_tokens_per_s=res["prefill_tokens_per_s"],
                          decode_tokens_per_s=res["decode_tokens_per_s"],
                          decode_step_median_ms=step["median_ms"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
