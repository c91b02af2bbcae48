"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` file under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with ``ctypes``. The build happens at first use, one ``nvcc`` per
source started together, into ``_build/`` beside this file (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a fresh
checkout builds its own kernels and a rebuilt tree never loads a stale
library.

No ``--use_fast_math``: the int8 quantizer needs IEEE division, and the
fused dequantizer an IEEE multiply and round-to-nearest-even downcasts,
to match the NumPy reference bit for bit (nvcc's default
``-prec-div=true``); flash attention keeps full-precision ``expf`` and
``tanhf``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_U64 = ctypes.c_uint64
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_F32 = ctypes.c_float

#: C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    # (data, nbytes, out uint32[2], num_blocks, stream)
    "th_checksum": (_P, _U64, _P, _INT, _P),
    # (x, dtype code, n elements, q int8[rows*256], scales f32[rows], rows, stream)
    "th_quantize_rows": (_P, _INT, _U64, _P, _P, _U64, _P),
    # (staging, out, runs int64[R,3], R, blocks_x, blocks_y, stream)
    "th_gather_bytes": (_P, _P, _P, _INT, _INT, _INT, _P),
    # (descriptors int64[P,8], P, out, blocks_x, blocks_y, stream)
    "th_dequant_gather": (_P, _INT, _P, _INT, _INT, _P),
    # (q, k, v, o, strides int64[12] on the host, dtype code, B, Hq, Hkv,
    #  Sq, D, Dv, causal, softcap, q_offset, kv_len, window (0: none),
    #  lse f32[B,Hq,Sq] or null, stream); D in {16, 32, 64, 80, 128, 256} with
    #  Dv = D, or (D, Dv) = (24, 16)
    "th_flash_attention": (_P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                           _F32, _INT, _INT, _INT, _P, _P),
    # (q, k, v, o, strides int64[12] on the host, B, Hq, Hkv, Sq, D, Dv,
    #  causal, softcap, q_offset, kv_len, window, lse f32[B,Hq,Sq] or null,
    #  stream); bf16, (D, Dv) in {(64, 64), (80, 80), (128, 128), (256, 256), (192, 128)}
    "th_flash_attention_tc": (_P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _F32, _INT, _INT,
                              _INT, _P, _P),
    # (q_abs, q_rope, ckv, krope, out f32, B, H, ckv batch and slot strides,
    #  krope batch and slot strides, kv_len, keys_per_split, nsplit, scale,
    #  f32 scratch, stream); bf16 in, R 512, rope 64
    "th_mla_decode": (_P, _P, _P, _P, _P, _INT, _INT, _I64, _I64, _I64, _I64, _INT, _INT, _INT, _F32, _P, _P),
    # (q, k, v, o, strides int64[12] on the host, dtype code, B, Hq, Hkv, Sq,
    #  D, causal, softcap, q_offset, kv_len, window, keys_per_split, nsplit,
    #  f32 scratch, int32 split counters, lse f32[B,Hq,Sq] or null, stream)
    "th_flash_decode": (_P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _F32, _INT, _INT,
                        _INT, _INT, _INT, _P, _P, _P, _P),
    # (q, k, v, o, do, dq, dk, dv, lse f32[B,Hq,Sq], stats f32 scratch of
    #  B*Hkv*nsub2*128, strides int64[24] on the host, dtype code, B, Hq, Hkv,
    #  Sq, Sk, D, Dv, causal, softcap, q_offset, kv_len, window, stream); the
    #  three CUDA-core backward kernels take the same
    **{f"th_flash_bwd_{k}": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                             _INT, _INT, _F32, _INT, _INT, _INT, _P) for k in ("pre", "dkdv", "dq")},
    # (q, k, v, o, do, dq, dk, dv, lse f32[B,Hq,Sq], stats f32 scratch of
    #  B*Hq*ceil(Sq/64)*128, strides int64[24] on the host, B, Hq, Hkv, Sq, Sk, D, Dv,
    #  causal, softcap, q_offset, kv_len, window (0: none), stream); bf16, (D,
    #  Dv) in {(64, 64), (80, 80), (128, 128), (256, 256), (192, 128)}; the three
    #  tensor-core backward kernels take the same
    **{f"th_flash_bwd_tc_{k}": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT,
                                _INT, _INT, _F32, _INT, _INT, _INT, _P) for k in ("pre", "dkdv", "dq")},
    # one launch of dK/dV and dQ (head_dim 256; the tensor cores' (192,
    # 128)): each route's arguments with the work list (int32 on the
    # device) and the grid before the stream
    "th_flash_bwd_dkdv_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                             _INT, _INT, _F32, _INT, _INT, _INT, _P, _INT, _P),
    "th_flash_bwd_tc_dkdv_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT,
                                _INT, _INT, _F32, _INT, _INT, _INT, _P, _INT, _P),
}


class LaunchCount:
    """A kernel's launch counter: a plain integer, bumped by its wrapper
    right where it launches the kernel and nowhere else. Locked because
    the windowed data plane launches from several threads."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
            "kernels of repro_torch are built at first use on a machine with "
            "the CUDA toolkit"
        )
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    cus, headers = _sources()
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtensorhub_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels (if this exact source set is not built yet) and
    return the shared library's path. The compiler's output, including
    ``ptxas`` register and spill counts, is kept beside it as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in cus:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append(
                (src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            )
        logs, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        so.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp_so, so)  # atomic: concurrent builders never see half a file
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it); a negative
    code is a driver error (``CUresult``) from building a TMA tensor map."""
    if err < 0:
        raise RuntimeError(f"{name}: driver error {-err} encoding a tensor map")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
