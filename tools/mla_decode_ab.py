#!/usr/bin/env python3
"""Times the absorbed-MLA decode kernel of one tree of the port on the card.

``mla_decode`` at deepseek-v3's widths (q_abs [4, 128, 1, 512], q_rope [4,
128, 1, 64] bf16 against ckv [4, S, 512] and krope [4, S, 64] bf16, the
scale 1/sqrt(192)) at the served step (phase 12: 528 of 528 slots) and at
a long cache (8192 of 8192 slots): the device time of a call with the L2
cache evicted first (``cold_ms``), the profiler's kernel time with the
inputs warm (``warm_ms``, every kernel the call launches summed) and each
kernel of the call by name (``warm_by_kernel``), with ``chip_smoke.py``'s
helpers, beside the plain f32 einsums (``mla_decode_plain``) and the bound
(``chip_smoke.mla_decode_bound_ms``). Each case is checked against the
plain version within 2e-5 of the output's max |value|. ``--tree`` names the
root of the checkout whose ``src/repro_torch`` is timed (default: this
one), so two commits compare on one card in one call, in turns:

    git archive <parent> | tar -x -C _tree_check/parent
    for t in _tree_check/parent . . _tree_check/parent; do
        python3 tools/mla_decode_ab.py --tree $t; done

``--keys K`` (repeatable) also times the served step with splits of K
keys in place of ``split_plan``'s (a multiple of 32), to compare split
plans on one card. Each run builds its tree's kernels into that tree's own
``_build``. It prints the card's name and power limit, the ptxas lines of
the tree's ``mla_decode.cu``, a digest of every other source's ptxas
register and spill lines (equal digests: those kernels compiled as
before; ptxas's advisories are left out, their mangled names differ by
the tree's path), the count of each tensor-core (``HGMMA``) and TMA (``UTMALDG``)
instruction shape in the SASS of its kernels (``cuobjdump -sass``), then
one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

#: (name, batch, heads, slots, kv_len)
CASES = [("served", 4, 128, 528, 528), ("long_cache", 4, 128, 8192, 8192)]
TOL = 2e-5  # of the output's max |value|, as chip_smoke.MLA_DECODE_TOL


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE), help="root of the checkout whose kernels are timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--keys", type=int, action="append", default=[],
                    help="also time the served step with splits of this many keys")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("mla_decode_ab: needs a CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))  # chip_smoke's timing helpers
    from torch.profiler import ProfilerActivity

    from chip_smoke import cold_ms, device_ms, memory_rate, mla_decode_bound_ms, ptxas_lines, sass_counts, traced
    from repro_torch.kernels import build
    from repro_torch.kernels import mla_decode as md

    assert Path(md.__file__).resolve().is_relative_to(tree), md.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    so = build.build()
    build.library()
    log = so.with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    src = text.split("== mla_decode.cu", 1)[-1].split("\n== ", 1)[0]
    for line in ptxas_lines(src):
        print("ptxas", line, flush=True)
    # each kernel's register and spill lines, not ptxas's advisories (C75xx),
    # whose mangled names carry a hash of the source's path
    others = sorted(ln for sec in text.split("== ")[1:] if not sec.startswith("mla_decode.cu")
                    for ln in ptxas_lines(sec) if ("registers" in ln or "spill" in ln) and "(C75" not in ln)
    digest = hashlib.sha256("\n".join(others).encode()).hexdigest()
    print("ptxas_others", json.dumps(dict(lines=len(others), sha256=digest)), flush=True)
    print("sass", json.dumps(sass_counts(so, "mla")), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(24)
    _, bw = memory_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    scale = 1.0 / math.sqrt(192)
    plan = md.split_plan
    out = {}
    for name, b, h, smax, kv_len in CASES:
        qa, qr = (torch.randn((b, h, 1, d), generator=g, device=dev).to(torch.bfloat16) for d in (512, 64))
        ckv, kr = (torch.randn((b, smax, d), generator=g, device=dev).to(torch.bfloat16) for d in (512, 64))
        want = md.mla_decode_plain(qa, qr, ckv, kr, kv_len=kv_len, scale=scale)
        plans = {"split_plan": None, **{f"keys {k}": k for k in (args.keys if name == "served" else ())}}
        rec = dict(b=b, heads=h, slots=smax, kv_len=kv_len, split_plan=plan(kv_len, b, h))
        for label, keys in plans.items():
            md.split_plan = plan if keys is None else (lambda n, *_, k=keys: (k, -(-n // k)))

            def kernel():
                return md.mla_decode(qa, qr, ckv, kr, kv_len=kv_len, scale=scale)

            got = kernel()
            ratio = float((got - want).abs().max()) / (TOL * float(want.abs().max()))
            same = bool(torch.equal(kernel(), got))
            events, _ = traced(torch, lambda: [kernel() for _ in range(args.reps)], [ProfilerActivity.CUDA])
            by_kernel = {}
            for e in events:
                by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / args.reps * 1e-3
            rec[label] = dict(splits=md.split_plan(kv_len, b, h), cold_ms=cold_ms(torch, kernel, flush, reps=args.reps),
                              warm_ms=device_ms(torch, kernel, reps=args.reps), warm_by_kernel=by_kernel,
                              err_over_tol=ratio, bit_equal_rerun=same)
            if ratio > 1.0 or not same or not torch.isfinite(got).all():
                print(f"mla_decode_ab: {name} {label}: kernel != plain version ({ratio:.3f} of the tolerance) "
                      f"or reruns differ", file=sys.stderr)
                return 1
        md.split_plan = plan

        def plain():
            return md.mla_decode_plain(qa, qr, ckv, kr, kv_len=kv_len, scale=scale)

        bound, by = mla_decode_bound_ms(b, h, kv_len, bw)[:2]
        rec.update(plain_cold_ms=cold_ms(torch, plain, flush, reps=5), plain_warm_ms=device_ms(torch, plain, reps=5),
                   bound_ms=bound, bound_by=by, bound_share=bound / rec["split_plan"]["cold_ms"])
        out[name] = rec
        del qa, qr, ckv, kr, want
        torch.cuda.empty_cache()
    print(json.dumps(dict(tree=str(args.tree), card=smi, cases=out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
