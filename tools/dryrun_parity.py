"""The port's dry-run records beside the JAX package's, cell by cell, as a
markdown table.

Each side is a directory of per-cell JSON records as the two entry points
write them (``--out``), one file a cell and mesh::

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all --mesh both --out <ref>
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --jobs 4 --out <port>
    python tools/dryrun_parity.py <ref> <port>

One row a cell: for each mesh the collective GB a device a step of the
JAX package (XLA's cost analysis of the compiled program) and of the port
(``launch.op_costs``: the eager ops of each rank's DTensor blocks) and
their ratio, marked where the port is over the parity bound,
``PARITY_FACTOR`` x the reference + ``PARITY_SLACK_BYTES``; then, on the
16x16 mesh, both sides' collective GB by kind (AG all-gather, AR
all-reduce, RS reduce-scatter, A2A all-to-all, CP collective-permute),
dot FLOPs and HBM bytes a device. The last line names the port's release
(its records carry it) and the cells over the bound. Exits 1 if a record
is missing, failed, or over the bound.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

PARITY_FACTOR = 3
PARITY_SLACK_BYTES = 64e6
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
SHORT = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS", "all-to-all": "A2A",
         "collective-permute": "CP"}


def load(directory: str) -> dict:
    """``{(arch, shape, mesh, flags): record}`` of a directory of records."""
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as fh:
            rec = json.load(fh)
        out[(rec["arch"], rec["shape"], rec["mesh"], tuple(sorted(rec.get("opt") or {})))] = rec
    return out


def gb(x: float) -> str:
    return f"{x / 1e9:.4g}"


def kinds(rec: dict) -> str:
    by = rec.get("collective_bytes", {})
    return " ".join(f"{SHORT[k]} {gb(by[k])}" for k in KINDS if by.get(k)) or "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ref", help="the JAX package's records")
    ap.add_argument("port", help="the port's records")
    args = ap.parse_args(argv)
    ref, port = load(args.ref), load(args.port)
    cells = sorted({(a, s, f) for a, s, _, f in ref} | {(a, s, f) for a, s, _, f in port})
    meshes = ("16x16", "2x16x16")
    print("| cell | " + " | ".join(f"{m} coll. GB ref / port (x)" for m in meshes)
          + " | 16x16 by kind, GB: ref; port | FLOPs ref / port | HBM B ref / port |")
    print("|---|" + "---|" * len(meshes) + "---|---|---|")
    over, missing, releases = [], [], set()
    for arch, shape, flags in cells:
        name = " ".join([arch, shape, *flags])
        cols = []
        for mesh in meshes:
            r, p = ref.get((arch, shape, mesh, flags)), port.get((arch, shape, mesh, flags))
            if not (r and p and r.get("ok") and p.get("ok")):
                missing.append(f"{name} {mesh}")
                cols.append("-")
                continue
            releases.add(p.get("torch"))
            rb, pb = float(r["collective_bytes_per_device"]), float(p["collective_bytes_per_device"])
            within = pb <= PARITY_FACTOR * rb + PARITY_SLACK_BYTES
            if not within:
                over.append(f"{name} {mesh}")
            cols.append(f"{gb(rb)} / {gb(pb)} ({pb / rb:.3g}{'' if within else ', **over**'})")
        r, p = ref.get((arch, shape, "16x16", flags)), port.get((arch, shape, "16x16", flags))
        if r and p and r.get("ok") and p.get("ok"):
            work = (f"{kinds(r)}; {kinds(p)} | {r['flops_per_device']:.3e} / {p['flops_per_device']:.3e} | "
                    f"{r['hbm_bytes_per_device']:.3e} / {p['hbm_bytes_per_device']:.3e}")
        else:
            work = "- | - | -"
        print(f"| {name} | " + " | ".join(cols) + f" | {work} |")
    print(f"\nport releases: {sorted(map(str, releases))}; cells over the bound: {over or 'none'}; "
          f"missing or failed: {missing or 'none'}")
    return 1 if over or missing else 0


if __name__ == "__main__":
    sys.exit(main())
