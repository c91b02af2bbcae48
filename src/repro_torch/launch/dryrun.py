"""Multi-pod dry run on H100s: trace every (architecture x input shape)
cell on the production meshes (16x16 single-pod, 2x16x16 multi-pod) with
coherent placements and count its per-device work; the port's counterpart
of the JAX package's ``launch/dryrun.py``. Nothing is allocated: the
inputs are fake tensors of each rank's block (:mod:`repro_torch.launch.cells`).

The JAX dry run fakes 512 host devices in its own entry point only; this
one starts a ``torch.distributed`` process group of the ``"fake"`` backend
(256 or 512 ranks in this one process, this process rank 0) in
:func:`main` only, never on import: a test or a benchmark keeps the
process group it has (the smoke mesh's at world 1). Each cell's counts
come from :func:`repro_torch.launch.op_costs.analyze_cell` (cut depths,
extended to the config's), its three terms from
:mod:`repro_torch.launch.roofline`. A cell the port refuses (the
hybrid's and the xLSTM's, whose sharded steps are not ported:
``NotImplementedError``) is written with ``"ok": false`` and the
refusal's text, and ``--all`` exits 1 while any is refused, as the JAX
one exits 1 on any failure.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, live_shapes
from repro_torch.launch.cells import live_cells
from repro_torch.launch.mesh import MeshShape, make_production_mesh, mesh_num_devices
from repro_torch.launch.roofline import model_flops, roofline_from_costs

def start_fake_world(world: int) -> None:
    """A process group of ``world`` fake ranks in this process (rank 0):
    collectives return at once and move nothing. Only an entry point calls
    this."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(f"dryrun: a process group of {dist.get_world_size()} ranks is running; "
                               f"the dry run needs {world} fake ones")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


_MESHES: Dict[MeshShape, Any] = {}


def device_mesh(shape: MeshShape) -> Any:
    """The ``DeviceMesh`` of a production mesh description over the fake
    ranks ``0 .. n - 1``, laid out row-major (made once a description:
    each makes its process groups)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    if shape not in _MESHES:
        n = mesh_num_devices(shape)
        _MESHES[shape] = DeviceMesh("cpu", torch.arange(n).reshape(shape.shape), mesh_dim_names=shape.mesh_dim_names)
    return _MESHES[shape]


def run_cell(arch: str, shape: str, *, multi_pod: bool, verbose: bool = True,
             opt: Optional[dict] = None) -> Dict[str, Any]:
    """One cell's record: the JAX ``run_cell``'s keys, ``trace_s`` (the
    traces' seconds) in place of ``lower_s``/``compile_s``, the PyTorch
    release (``torch``: DTensor's sharding strategies, and so the counts,
    change between releases; compare records of one release), the depths
    traced, the collective bytes by link and, under ``memory_analysis``,
    this rank's argument and output bytes and the peak the step allocates
    beside them (``temp_bytes``, from ``mem_tracker``, extended over depth
    as the counts), on the production mesh's ``DeviceMesh`` over the fake
    ranks (:func:`start_fake_world` first)."""
    from repro_torch.launch.op_costs import analyze_cell

    mesh = device_mesh(make_production_mesh(multi_pod=multi_pod))
    chips = mesh_num_devices(mesh)
    t0 = time.time()
    rec = analyze_cell(arch, shape, mesh, opt=opt, memory=True)
    t_trace = time.time() - t0
    costs = rec["costs"]
    roof = roofline_from_costs(costs, chips, peak_memory=rec["argument_bytes"] + rec["temp_bytes"])
    cfg, case = get_config(arch), SHAPES[shape]
    mf = model_flops(cfg, case)
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": "x".join(map(str, mesh.shape)),
        "chips": chips,
        "opt": opt or {},
        "kind": case.kind,
        "torch": torch.__version__,
        "ok": True,
        "trace_s": round(t_trace, 1),
        "depths": rec["depths"],
        "flops_per_device": roof.flops_per_device,
        "hbm_bytes_per_device": roof.hbm_bytes_per_device,
        "collective_bytes_per_device": roof.collective_bytes_per_device,
        "collective_counts": roof.collectives.count_by_kind,
        "collective_bytes": roof.collectives.bytes_by_kind,
        "collective_bytes_by_link": roof.collectives.bytes_by_link,
        "compute_s": roof.compute_s,
        "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "dominant": roof.dominant,
        "model_flops": mf,
        "model_flops_fraction": roof.model_flops_fraction(mf),
        "roofline_fraction": roof.roofline_fraction(mf),
        "memory_analysis": {
            "argument_bytes": rec["argument_bytes"],
            "output_bytes": rec["output_bytes"],
            "temp_bytes": rec["temp_bytes"],
            "peak_bytes": roof.peak_memory_per_device,
        },
    }
    if verbose:
        print(f"[{result['mesh']}] {arch} x {shape} ({result['kind']}): traced at {rec['depths']} layers "
              f"in {t_trace:.0f}s")
        print(f"  memory: {result['memory_analysis']}")
        print(f"  costs: flops/dev={roof.flops_per_device:.3e} hbm B/dev={roof.hbm_bytes_per_device:.3e} "
              f"collective B/dev={roof.collective_bytes_per_device:.3e}")
        print(f"  roofline: compute {roof.compute_s * 1e3:.1f}ms | memory {roof.memory_s * 1e3:.1f}ms | collective "
              f"{roof.collective_s * 1e3:.1f}ms -> {roof.dominant}-bound; useful/traced flops "
              f"{result['model_flops_fraction']:.2f}; roofline fraction {result['roofline_fraction']:.2f}",
              flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true", help="run every live cell")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON results")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", action="append", default=[],
                    help="optimization flags, e.g. --opt shardmap_moe")
    args = ap.parse_args(argv)
    opt = {name: True for name in args.opt}

    if args.all:
        cells = live_cells()
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        shapes = [args.shape] if args.shape else live_shapes(get_config(args.arch))
        cells = tuple((args.arch, s) for s in shapes)

    import torch

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    start_fake_world(256 if args.mesh == "single" else 512)
    failures = []
    for arch, shape in cells:
        for multi in meshes:
            tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
            if opt:
                tag += "__" + "_".join(sorted(opt))
            out_path = os.path.join(args.out, tag + ".json") if args.out else None
            if out_path and args.skip_existing and os.path.exists(out_path):
                print(f"skip {tag} (exists)")
                continue
            try:
                result = run_cell(arch, shape, multi_pod=multi, opt=opt)
            except Exception as e:  # noqa: BLE001 - report and continue
                if not isinstance(e, NotImplementedError):
                    traceback.print_exc()
                print(f"[{'2x16x16' if multi else '16x16'}] {arch} x {shape}: {type(e).__name__}: {e}", flush=True)
                result = {
                    "arch": arch, "shape": shape,
                    "mesh": "2x16x16" if multi else "16x16",
                    "torch": torch.__version__, "ok": False, "error": f"{type(e).__name__}: {e}",
                }
                failures.append(tag)
            if out_path:
                os.makedirs(args.out, exist_ok=True)
                with open(out_path, "w") as f:
                    json.dump(result, f, indent=1)
    if failures:
        print(f"\nFAILED cells: {failures}")
        return 1
    print("\nall requested cells traced OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
