"""Build and load the port's CUDA kernels (lrr_tpu_torch/csrc/*.cu).

Each source is compiled with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, at first use, into `build/lrr_tpu_torch/`
at the repo root; the compilers of all sources run side by side.  A library
is named by a hash of its source and the flags (a changed source rebuilds).
The libraries are loaded with ctypes; each C entry point launches on the
stream it is given and returns `cudaGetLastError()`.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent module only builds when a CUDA tensor reaches a kernel.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "lrr_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # pointers (host array of 17 device pointers), strides (host array of
    # 26 element strides), L, M_f, M_b, stream
    "lrr_normal_equations_sym": [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
        _I, _I, _I, _P,
    ],
    # queries, points, mask, out_d, out_i, part_d, part_i, Q, N, D, k,
    # wide tiles (0/1), point splits, stream
    "lrr_knn": [_P] * 7 + [_I] * 6 + [_P],
    # D, k, wide tiles (0/1) -> shared-memory bytes of one K2 block
    "lrr_knn_smem_bytes": [_I, _I, _I],
    # a, out, rotations (or null), L, n, rtol, stream
    "lrr_pinv_sym": [_P, _P, _P, _I, _I, ctypes.c_double, _P],
    # xyz, mask, origin, spacing, packed, count, out, stats (or null), n, D,
    # H, W, stream
    "lrr_voronoi_nearest": [_P] * 8 + [_I] * 4 + [_P],
    # order, rows, lane_mask, valid, offset, number, A, t, center, origin,
    # spacing, index_vol, dst_rows, src, dst, weight, mask, order_cols,
    # mask_cols, L, m, p0, cap, D, H, W, stream
    "lrr_sample_matches": [_P] * 17 + [_LL] * 2 + [_I] * 2 + [_LL] * 2 + [_I] * 3 + [_P],
    # pointers (host array of 20), strides (host array of 28), L, M_f, M_b,
    # spatial falloff, stream
    "lrr_robust_weights": [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
        _I, _I, _I, ctypes.c_float, _P,
    ],
    # L, M_f, M_b -> floats of global scratch K6 needs (0: shared memory)
    "lrr_robust_scratch_floats": [_I, _I, _I],
    # pointers (host array of 15), strides (host array of 28), L, M_f, M_b,
    # stream
    "lrr_weighted_error": [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong), _I, _I, _I, _P,
    ],
    # stream: an empty kernel, for the launch floor
    "lrr_empty": [_P],
}

_RESTYPES = {"lrr_robust_scratch_floats": ctypes.c_longlong}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"liblrr_{stem}_{h.hexdigest()[:16]}.so")


def build() -> tuple[list[str], float]:
    """Compile every kernel library whose hash is not built yet, all at
    once.  Returns (paths, seconds spent compiling; 0.0 when all were
    built).  The compiler's register/spill report of each is kept beside it
    as `<lib>.log`."""
    paths = [library_path(s) for s in sources()]
    todo = [(s, p) for s, p in zip(sources(), paths) if not os.path.exists(p)]
    if not todo:
        return paths, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [
        (out, f"{out}.{os.getpid()}.tmp",
         subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", f"{out}.{os.getpid()}.tmp", src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, out in todo
    ]
    failures = []
    for out, tmp, proc in procs:
        log, _ = proc.communicate()
        with open(out + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}) for {out}:\n{log[-4000:]}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths, time.perf_counter() - t0


def build_logs() -> dict[str, str]:
    """The kept compiler report of each built library, by source stem."""
    logs = {}
    for s in sources():
        path = library_path(s) + ".log"
        if os.path.exists(path):
            with open(path) as f:
                logs[os.path.splitext(os.path.basename(s))[0]] = f.read()
    return logs


@functools.lru_cache(maxsize=None)
def library() -> types.SimpleNamespace:
    """The loaded kernel entry points (built on first call)."""
    paths, _ = build()
    libs = [ctypes.CDLL(p) for p in paths]
    fns = types.SimpleNamespace(_libs=libs)  # keeps the libraries loaded
    for name, argtypes in _SIGNATURES.items():
        fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
        setattr(fns, name, fn)
    return fns


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
