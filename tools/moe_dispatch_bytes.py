"""What dbrx-132b's routed-expert FFN moves between ranks on the faked 16x16
mesh, with H3 off and on, from the dry run's counts (``launch.op_costs``).

With H3 off, the dispatch is placed (``blocks._moe_placed``): each rank
routes and sorts its own tokens' pairs, one all-gather of the ``[E]``
counts over the batch axes places them in the global order, the buffer
of the rank's experts is summed over the batch axes (reduce-scattered
over a batch axis that also splits the experts, their outputs gathered
back) and the combine is summed over the model axis. With H3 on
(``shardmap_moe``), each rank dispatches its own tokens to its own experts
and one ``all_reduce`` over the model axis combines them. For each
forward-only cell (prefill_32k, decode_32k) and each setting the script
traces the cell at two depths one layer apart, past the first layers'
settling (``--depth``), and prints one JSON line a setting: the step's
counts at full depth (``op_costs.analyze_cell``) and one MoE layer's
collectives by kind and bytes within each of ``SCOPES`` it ran: the
placed dispatch (``blocks._moe_placed``, H3 off), or H3's
(``blocks.moe_apply_shardmap``). A forward's collectives all happen
inside these calls' extent; a train step's backward ones do not, so
train_4k is given as the whole step's counts only (``--train``). A tree
older than the placed dispatch reports its ``blocks.dispatch`` and
``blocks._experts_combined`` instead.

Nothing is allocated and no card is used: a process group of 256 fake
ranks lives in this process.

    PYTHONPATH=src python tools/moe_dispatch_bytes.py [--depth 3] [--train]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

SCOPES = ("_moe_placed", "dispatch", "_experts_combined", "moe_apply_shardmap")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--depth", type=int, default=3, help="the shallower of the two traced depths")
    ap.add_argument("--train", action="store_true", help="also train_4k's whole-step counts, H3 off and on")
    args = ap.parse_args(argv)

    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    from repro_torch.launch import cells, dryrun, op_costs
    from repro_torch.models import blocks

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    dryrun.start_fake_world(256)
    mesh = dryrun.device_mesh(dryrun.make_production_mesh())
    scoped = {}

    def counter():
        for mode in _get_current_dispatch_mode_stack():
            if isinstance(mode, op_costs.OpCounter):
                return mode
        return None

    def wrap(name):
        real = getattr(blocks, name)

        def run(*a, **kw):
            c = counter()
            before = json.loads(json.dumps(c.costs.as_dict())) if c else None
            out = real(*a, **kw)
            if c:
                after = c.costs.as_dict()
                rec = scoped.setdefault(name, {"counts": {}, "bytes": {}})
                for kind in after["collective_counts"]:
                    rec["counts"][kind] = rec["counts"].get(kind, 0) + (after["collective_counts"][kind]
                                                                       - before["collective_counts"][kind])
                    rec["bytes"][kind] = rec["bytes"].get(kind, 0) + (after["collective_bytes"][kind]
                                                                     - before["collective_bytes"][kind])
            return out

        setattr(blocks, name, run)

    for name in SCOPES:
        if hasattr(blocks, name):
            wrap(name)

    for shape in ("prefill_32k", "decode_32k"):
        for h3 in (False, True):
            opt = {"shardmap_moe": True} if h3 else {}
            layers = {}
            for depth in (args.depth, args.depth + 1):
                scoped.clear()
                cells.build_cell("dbrx-132b", shape, mesh, opt=opt, layers=depth).trace(mesh)
                layers[depth] = json.loads(json.dumps(scoped))
            per_layer = {}
            for name in SCOPES:
                a, b = layers[args.depth].get(name), layers[args.depth + 1].get(name)
                if b is None:
                    continue
                a = a or {"counts": {}, "bytes": {}}
                per_layer[name] = {k: {kind: b[k][kind] - a[k].get(kind, 0) for kind in b[k]} for k in ("counts", "bytes")}
            whole = op_costs.analyze_cell("dbrx-132b", shape, mesh, opt=opt)["costs"]
            print(json.dumps({"cell": f"dbrx-132b {shape}", "h3": h3, "depths": [args.depth, args.depth + 1],
                              "one_moe_layer": per_layer, "step": whole.as_dict()}), flush=True)
    if args.train:
        for h3 in (False, True):
            opt = {"shardmap_moe": True} if h3 else {}
            whole = op_costs.analyze_cell("dbrx-132b", "train_4k", mesh, opt=opt)["costs"]
            print(json.dumps({"cell": "dbrx-132b train_4k", "h3": h3, "step": whole.as_dict()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
