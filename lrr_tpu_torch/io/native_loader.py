"""ctypes bindings for the native IO runtime (io/native/lrr_native.cpp;
counterpart of lrr_tpu/io/native_loader.py).

Builds the shared library on demand with g++ into `build/lrr_tpu_torch/` at
the repo root (named by a hash of the source, so a changed source rebuilds);
every entry point has a pure-Python fallback (lrr_tpu_torch.io.mhd) so the
package works on a host without a toolchain.  This is host I/O only: no
device code depends on it.  `reader_kind()` says which reader serves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "lrr_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "lrr_tpu_torch")
_GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_GXX_LIBS = ["-lz", "-lpthread"]

_ELEMENT_DTYPES = {
    0: np.int8, 1: np.uint8, 2: np.int16, 3: np.uint16,
    4: np.int32, 5: np.uint32, 6: np.float32, 7: np.float64,
}

_lock = threading.Lock()
_lib = None
_build_failed = False


class MhdInfo(ctypes.Structure):
    _fields_ = [
        ("dims", ctypes.c_int32 * 3),
        ("spacing", ctypes.c_double * 3),
        ("origin", ctypes.c_double * 3),
        ("element_type", ctypes.c_int32),
        ("compressed", ctypes.c_int32),
        ("data_offset", ctypes.c_int64),
        ("data_file", ctypes.c_char * 512),
    ]


def library_path() -> str:
    h = hashlib.sha256(" ".join(_GXX_FLAGS + _GXX_LIBS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"liblrr_native_{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", *_GXX_FLAGS, _SRC, "-o", tmp, *_GXX_LIBS],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.lrr_mhd_parse_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(MhdInfo)]
        lib.lrr_mhd_parse_header.restype = ctypes.c_int
        lib.lrr_mhd_read_data.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(MhdInfo), ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.lrr_mhd_read_data.restype = ctypes.c_int
        lib.lrr_b64_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.lrr_b64_decode.restype = ctypes.c_int64
        lib.lrr_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.lrr_loader_create.restype = ctypes.c_void_p
        lib.lrr_loader_next_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(MhdInfo)]
        lib.lrr_loader_next_info.restype = ctypes.c_int
        lib.lrr_loader_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.lrr_loader_copy.restype = ctypes.c_int64
        lib.lrr_loader_skip.argtypes = [ctypes.c_void_p]
        lib.lrr_loader_skip.restype = None
        lib.lrr_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.lrr_loader_destroy.restype = None
        _lib = lib
        return _lib


def reader_kind() -> str:
    """"native" when the C++ runtime serves `VolumeLoader` and the base64
    decode, "python" when the pure-Python fallback does."""
    return "native" if get_lib() is not None else "python"


def _info_arrays(info: MhdInfo):
    dtype = np.dtype(_ELEMENT_DTYPES[info.element_type])
    dims = tuple(info.dims)  # (x, y, z)
    return dtype, dims, int(np.prod(dims)) * dtype.itemsize


def _as_volume(buf: np.ndarray, info: MhdInfo, dtype, dims):
    data = buf.view(dtype).reshape((dims[2], dims[1], dims[0]))
    return data, np.asarray(info.origin, np.float32), np.asarray(info.spacing, np.float32)


def read_mhd_native(path: str):
    """Native MHD read; returns (data [D,H,W], origin, spacing) or None if
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    info = MhdInfo()
    rc = lib.lrr_mhd_parse_header(path.encode(), ctypes.byref(info))
    if rc != 0:
        raise IOError(f"mhd header parse failed ({rc}): {path}")
    dtype, dims, n = _info_arrays(info)
    buf = np.empty(n, np.uint8)
    rc = lib.lrr_mhd_read_data(
        path.encode(), ctypes.byref(info), buf.ctypes.data_as(ctypes.c_void_p), n
    )
    if rc != 0:
        raise IOError(f"mhd data read failed ({rc}): {path}")
    return _as_volume(buf, info, dtype, dims)


def b64_decode_native(text: bytes) -> np.ndarray | None:
    """Base64 decode via the native runtime (whitespace-tolerant); returns a
    uint8 array or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    cap = (len(text) // 4 + 1) * 3
    out = np.empty(cap, np.uint8)
    n = lib.lrr_b64_decode(
        text, len(text), out.ctypes.data_as(ctypes.c_void_p), cap
    )
    if n < 0:
        return None
    return out[:n]


class VolumeLoader:
    """Threaded prefetching loader over a list of MHD paths; yields
    (data, origin, spacing) host arrays in order while worker threads
    read/decompress ahead.  A path that cannot be read raises at its turn
    and the loader goes on to the next one."""

    def __init__(self, paths, n_threads: int = 4, max_queue: int = 4):
        self.paths = list(paths)
        self._lib = get_lib()
        self._handle = None
        self._i = 0
        if self._lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._paths_keepalive = arr
            self._handle = self._lib.lrr_loader_create(
                arr, len(self.paths), n_threads, max_queue
            )

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self.paths):
            raise StopIteration
        self._i += 1
        if self._handle is None:
            from lrr_tpu_torch.io.mhd import read_mhd

            return read_mhd(self.paths[self._i - 1])
        info = MhdInfo()
        rc = self._lib.lrr_loader_next_info(self._handle, ctypes.byref(info))
        if rc == 1:
            raise StopIteration
        if rc != 0:
            # drop the failed item, so the paths behind it are still served
            self._lib.lrr_loader_skip(self._handle)
            raise IOError(f"loader failed on {self.paths[self._i - 1]} ({rc})")
        dtype, dims, n = _info_arrays(info)
        buf = np.empty(n, np.uint8)
        got = self._lib.lrr_loader_copy(
            self._handle, buf.ctypes.data_as(ctypes.c_void_p), n
        )
        if got != n:
            raise IOError(f"loader copy failed ({got} != {n})")
        return _as_volume(buf, info, dtype, dims)

    def close(self):
        if self._handle is not None:
            self._lib.lrr_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
