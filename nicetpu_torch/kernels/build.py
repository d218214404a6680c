"""Build and load the CUDA kernels of `csrc/` as one shared library.

nvcc compiles every `csrc/*.cu` for sm_90a, one process per source, all
started together, and links the objects into
`nicetpu_torch/_build/libnicetpu_kernels.so`, which has a plain C interface
and is loaded with ctypes (no PyTorch headers, so the build takes seconds).
The build runs at first use and again whenever a source or header is newer
than the library.  nvcc is taken from PATH, else from $CUDA_HOME/bin.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libnicetpu_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")
    return path


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; return their output, raise on failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    return log


def build() -> tuple[float, str]:
    """Compile the library; return (seconds, nvcc's output with the
    per-kernel register and shared-memory report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    base = [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o") for s in sources()]
    t0 = time.perf_counter()
    log = _run_all([[*base, "-Xptxas", "-v", "-c", "-o", o, s] for s, o in zip(sources(), objs)])
    tmp = f"{LIB}.{tag}"
    log += _run_all([[*base, "-shared", "-o", tmp, *objs]])
    seconds = time.perf_counter() - t0
    for o in objs:
        os.remove(o)
    os.replace(tmp, LIB)  # atomic: a concurrent loader never sees half a file
    return seconds, log


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    newest = max(os.path.getmtime(p) for p in glob.glob(os.path.join(CSRC, "*")))
    return os.path.getmtime(LIB) < newest


_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each entry point's argument types; every one ends in (device, stream)
SIGNATURES = {
    "nt_histogram": [_vp, _vp, _i32, _i64, _i32, _vp],
    "nt_table_join": [_vp, _vp, _vp, _vp, _vp, _i32, _i64, _i32, _vp],
    "nt_fold_records": [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _vp],
    "nt_walk": [_vp, _i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32,
                _i32, _vp],
    "nt_value_join": [_vp, _vp, _vp, _i32, _i32, _i64, _i32, _vp],
    "nt_reconstruct_rows": [_vp, _vp, _vp, _vp, _vp, _vp, _i32, _vp, _i32, _i32, _i32, _i32, _vp],
    "nt_recon_plan": [_i32, _i32, _vp, _vp],
    "nt_huffman_tables": [_vp, _i32, _vp, _vp, _vp, _i32, _i32, _vp],
    "nt_first_change": [_vp, _vp, _i32, _i64, _i64, _i64, _i64, _i64, _i32, _vp],
    "nt_tokenize_bins": [_vp, _vp, _i32, _vp, _vp, _i64, _i64, _i32, _i64, _i64, _i64, _i64, _i64, _i32, _i32,
                         _i32, _vp, _i32, _vp],
    "nt_decode_tables": [_vp, _i32, _vp, _i32, _i32, _i32, _vp],
    "nt_walk_tables": [_vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _vp],
    "nt_slot_scan": [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i64, _vp, _i32, _i32, _vp],
    "nt_slot_compact": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i64, _i64,
                        _vp, _i32, _i32, _vp],
    "nt_stitch_file": [_vp, _i64, _vp, _i32, _vp, _i32, _vp, _i64, _i32, _vp],
}


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ctypes.CDLL(LIB)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.nt_error_string.restype = ctypes.c_char_p
        lib.nt_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib
