#!/usr/bin/env python3
"""Times phase 20's decode_32k cell of ``chip_smoke.py`` (llama3-8b's
decode step at its published widths, 32 layers, 8 sequences against a
cache of 32768 slots, on DTensors on the 1x1 NCCL smoke mesh, through the
cells' model and step) for one tree of the port on the card.

Builds the tree's kernels, places the cell's inputs as phase 20 does
(``chip_smoke.card_cell_inputs``), runs a warm-up step and then
``--turns`` steps, and prints the card's name and power limit, then one
JSON line: each step's seconds (host clock around the call ended by a
synchronize) and the host's return time (the call alone, before the
synchronize). The step is host-bound and host speed differs between chip
calls, so compare two commits only in turns in one call:

    git archive <parent> | tar -x -C _tree_check/parent
    for t in _tree_check/parent . . _tree_check/parent; do
        python3 tools/decode_cell_ab.py --tree $t; done

Each tree builds its kernels into its own ``_build`` on first use.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE), help="root of the checkout whose decode cell is timed")
    ap.add_argument("--turns", type=int, default=8, help="timed steps after the warm-up")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("decode_cell_ab: needs a CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeCase
    from repro_torch.kernels import build
    from repro_torch.launch import make_smoke_mesh
    from repro_torch.launch.cells import _model
    from repro_torch.models.params import init_params
    from repro_torch.training import make_decode_step

    assert Path(chip_smoke.__file__).resolve().is_relative_to(tree), chip_smoke.__file__
    assert Path(build.__file__).resolve().is_relative_to(tree), build.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.build()
    build.library()
    mesh = make_smoke_mesh(dev)
    batch, layers = chip_smoke.CARD_CELLS["decode_32k"]
    c = SHAPES["decode_32k"]
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=layers)
    case = ShapeCase(c.name, c.seq_len, batch, c.kind)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 203), torch.bfloat16, dev)
    inputs = chip_smoke.card_cell_inputs(torch, dev, mesh, cfg, case, params)
    step = make_decode_step(_model(cfg))
    with torch.no_grad():
        step(*inputs)  # the warm-up
        torch.cuda.synchronize(dev)
        seconds, host = [], []
        for _ in range(args.turns):
            t0 = time.perf_counter()
            step(*inputs)
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
    print(json.dumps(dict(tree=str(args.tree), card=smi, torch=torch.__version__, seconds=seconds,
                          host_return_seconds=host, median_s=sorted(seconds)[len(seconds) // 2])), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
