"""Build and load the CUDA kernels of `csrc/` as one shared library.

nvcc compiles `csrc/encode_kernels.cu` for sm_90a into
`nicetpu_torch/_build/libnicetpu_kernels.so`, which has a plain C interface
and is loaded with ctypes (no PyTorch headers, so the build takes seconds).
The build runs at first use and again whenever the source is newer than
the library.  nvcc is taken from PATH, else from $CUDA_HOME/bin.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "encode_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libnicetpu_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")
    return path


def build() -> tuple[float, str]:
    """Compile the library; return (seconds, nvcc's output with the
    per-kernel register and shared-memory report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, SRC]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIB)  # atomic: a concurrent loader never sees half a file
    return seconds, " ".join(cmd) + "\n" + res.stdout + res.stderr


def _stale() -> bool:
    return not os.path.exists(LIB) or os.path.getmtime(LIB) < os.path.getmtime(SRC)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ctypes.CDLL(LIB)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.nt_error_string.restype = ctypes.c_char_p
        lib.nt_error_string.argtypes = [i32]
        lib.nt_histogram.restype = i32
        lib.nt_histogram.argtypes = [vp, vp, i32, i64, i32, vp]
        lib.nt_table_join.restype = i32
        lib.nt_table_join.argtypes = [vp, vp, vp, vp, vp, i32, i64, i32, vp]
        lib.nt_fold_records.restype = i32
        lib.nt_fold_records.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
        _lib = lib
        return lib
