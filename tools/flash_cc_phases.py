#!/usr/bin/env python3
"""Where a tile's cycles go in the CUDA-core flash kernels, on the card.

Copies ``src/repro_torch`` into ``src/repro_torch/kernels/_build/phases``,
puts ``clock64()`` counters between the phases of the loop of
``flash_kernel`` (the ``f32`` forward route) and of
``flash_bwd_dkdv_kernel`` (the ``cuda_core`` backward's dK/dV kernel),
builds that copy and runs both at the f32 training shape (q [16, 32, 576,
128], k/v [16, 8, 576, 128], causal), three calls each. It prints the
card's name and power limit, then one JSON line: for the forward, the
cycles a key tile spends in each phase as thread 0 (the first half of D)
and thread 128 (the second half) see them; for dK/dV, each phase's share
of the cycles of the first thread of each quarter. The counters cost a
few registers, so the copy runs a little slower than the kernels it
measures; its shares, not its times, are the result.

    python3 tools/flash_cc_phases.py
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "src" / "repro_torch" / "kernels" / "_build" / "phases"

TIMER = ('#include "vec.cuh"\n',
         '#include "vec.cuh"\n__device__ unsigned long long {name}[32];\n'
         "#define TP(i) do { long long _n = clock64(); tp[i] += _n - _c; _c = _n; } while (0)\n")
READER = ('\nextern "C" int th_{name}_read(unsigned long long* out) {{\n'
          "  cudaError_t e = cudaMemcpyFromSymbol(out, {name}, sizeof({name}));\n"
          "  unsigned long long z[32] = {{0}};\n  cudaMemcpyToSymbol({name}, z, sizeof(z));\n"
          "  return (int)e;\n}}\n")

FORWARD = [
    TIMER,
    ("    cp_async_wait_all();\n    __syncthreads();  // tile t is in; every thread is done with tile t - 1's stage, pt and alpha_s\n",
     "    cp_async_wait_all();\n    __syncthreads();\n    TP(0);\n"),
    ("  for (int t = 0; t < ntiles; ++t) {\n",
     "  unsigned long long tp[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long _c = clock64();\n"
     "  for (int t = 0; t < ntiles; ++t) {\n"),
    ("      copy_kv(t + 1, (t + 1) & 1);\n      cp_async_commit();\n    }\n",
     "      copy_kv(t + 1, (t + 1) & 1);\n      cp_async_commit();\n    }\n    TP(1);\n"),
    ("    nt_product<T, D, D / 2, RA, RC, 16, 8>(s, qs, hx, kt, tx, h * (D / 2));\n",
     "    nt_product<T, D, D / 2, RA, RC, 16, 8>(s, qs, hx, kt, tx, h * (D / 2));\n    TP(2);\n"),
    ("      store_n<FA>(pt + (tx + 8 * c) * PP + RA * hx + FA * (1 - h), o);\n    }\n    __syncthreads();\n",
     "      store_n<FA>(pt + (tx + 8 * c) * PP + RA * hx + FA * (1 - h), o);\n    }\n    __syncthreads();\n    TP(3);\n"),
    ("      store_n<FA>(pt + (tx + 8 * c) * PP + RA * hx + FA * h, o);\n    }\n    __syncthreads();\n",
     "      store_n<FA>(pt + (tx + 8 * c) * PP + RA * hx + FA * h, o);\n    }\n    TP(4);\n    __syncthreads();\n    TP(5);\n"),
    ("    nn_product<T, D, RA, PP, BK>(acc, pt, RA * ty, vt, cx);\n  }\n",
     "    nn_product<T, D, RA, PP, BK>(acc, pt, RA * ty, vt, cx);\n    TP(6);\n  }\n"
     "  if (threadIdx.x % 128 == 0 && sizeof(T) == 4 && D == 128) {\n"
     "    for (int i = 0; i < 7; ++i) atomicAdd(&g_fwd[i + 8 * (threadIdx.x / 128)], tp[i]);\n"
     "    atomicAdd(&g_fwd[7 + 8 * (threadIdx.x / 128)], (unsigned long long)ntiles);\n  }\n"),
]
FORWARD_PHASES = ["wait and barrier", "copy issue", "S partial products", "partials out and barrier",
                  "partials in, softmax, P out", "barrier", "rescale and P V"]

BACKWARD = [
    TIMER,
    ("  for (int sub = s_begin, it = 0; sub < p.nsub; ++sub, ++it) {\n",
     "  unsigned long long tp[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long _c = clock64();\n"
     "  for (int sub = s_begin, it = 0; sub < p.nsub; ++sub, ++it) {\n"),
    ("    __syncthreads();  // sub-tile `sub` is in; every thread is done with the other stage, pb and db\n",
     "    __syncthreads();\n    TP(0);\n"),
    ("      copy_sub(sub + 1, st ^ 1);\n      cp_async_commit();\n    }\n",
     "      copy_sub(sub + 1, st ^ 1);\n      cp_async_commit();\n    }\n    TP(1);\n"),
    ("    nt_product<T, D, D / 2, 8, 8, 8, 8>(s, prod ? vs : ks, hx, prod ? dot : qt, tx, dh * (D / 2));\n",
     "    nt_product<T, D, D / 2, 8, 8, 8, 8>(s, prod ? vs : ks, hx, prod ? dot : qt, tx, dh * (D / 2));\n    TP(2);\n"),
    ("      store_n<kFin>(buf + (tx + 8 * c) * PP + 8 * hx + other, o);\n    }\n    __syncthreads();\n",
     "      store_n<kFin>(buf + (tx + 8 * c) * PP + 8 * hx + other, o);\n    }\n    __syncthreads();\n    TP(3);\n"),
    ("    __syncthreads();\n    if (prod == 0) {  // dS^T", "    TP(4);\n    __syncthreads();\n    if (prod == 0) {  // dS^T"),
    ("    __syncthreads();\n    // dV[key] += sum_r P^T[key][r] dO[r]", "    TP(5);\n    __syncthreads();\n    TP(6);\n"
     "    // dV[key] += sum_r P^T[key][r] dO[r]"),
    ("    nn_product<T, D, 8, PP, kSub>(acc, half ? db : pb, 8 * ky, half ? qt : dot, cx);\n  }\n",
     "    nn_product<T, D, 8, PP, kSub>(acc, half ? db : pb, 8 * ky, half ? qt : dot, cx);\n    TP(7);\n  }\n"
     "  if (threadIdx.x % 64 == 0 && sizeof(T) == 4 && D == 128)\n"
     "    for (int i = 0; i < 8; ++i) atomicAdd(&g_dkdv[i + 8 * (threadIdx.x / 64)], tp[i]);\n"),
]
BACKWARD_PHASES = ["wait and barrier", "copy issue", "S^T or dP^T partial products", "partials out and barrier",
                   "partials in; P^T, or dP^T out", "dS^T (S^T quarters)", "barrier", "dV or dK products"]


def patch(path: Path, edits, name: str) -> None:
    text = path.read_text()
    for old, new in edits:
        old = old.replace("{name}", name)
        new = new.replace("{name}", name)
        if text.count(old) != 1:
            raise SystemExit(f"flash_cc_phases: {path.name} no longer has the line this tool times after:\n{old}")
        text = text.replace(old, new)
    path.write_text(text + READER.format(name=name))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_cc_phases: needs a CUDA device", file=sys.stderr)
        return 2
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "repro_torch", ignore=shutil.ignore_patterns("_build"))
    csrc = COPY / "repro_torch" / "kernels" / "csrc"
    patch(csrc / "flash_attention.cu", FORWARD, "g_fwd")
    patch(csrc / "flash_attention_bwd.cu", BACKWARD, "g_dkdv")
    sys.path.insert(0, str(COPY))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(COPY)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = build.library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, dout = (torch.randn(s, generator=g, device=dev) for s in
                     ((16, 32, 576, 128), (16, 8, 576, 128), (16, 8, 576, 128), (16, 32, 576, 128)))
    out, lse = fa.launch_route("f32", q, k, v, causal=True, with_lse=True)
    fa.launch_backward(q, k, v, out, lse, dout, causal=True, route="cuda_core")
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 32)()
    lib.th_g_fwd_read(buf)
    lib.th_g_dkdv_read(buf)  # both counters start from zero
    for _ in range(3):
        fa.launch_route("f32", q, k, v, causal=True)
    torch.cuda.synchronize()
    lib.th_g_fwd_read(buf)
    f = list(buf)
    forward = {f"thread {128 * h}": {name: f[8 * h + i] / f[8 * h + 7] for i, name in enumerate(FORWARD_PHASES)}
               for h in (0, 1)}
    for _ in range(3):
        fa.launch_backward(q, k, v, out, lse, dout, causal=True, route="cuda_core")
    torch.cuda.synchronize()
    lib.th_g_dkdv_read(buf)
    f = list(buf)
    dkdv = {}
    for quarter in range(4):
        total = sum(f[8 * quarter + i] for i in range(8))
        dkdv[f"quarter {quarter}"] = {name: f[8 * quarter + i] / total for i, name in enumerate(BACKWARD_PHASES)}
    print(json.dumps(dict(card=smi, shape="q [16,32,576,128], k/v [16,8,576,128] f32 causal",
                          forward_cycles_a_tile=forward, dkdv_share_of_cycles=dkdv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
