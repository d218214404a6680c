"""ctypes bindings for the native C++ `.nice` codec (nice_ref.cpp).

The port's own copy of `nicetpu/hostref/oracle.py` and `nice_ref.cpp`.
g++ builds `libniceref.so` at first use into the git-ignored
`nicetpu_torch/_build/`, never beside the source.  The native codec is
byte-identical to the numpy spec codec (same deterministic Huffman) and is
the port's byte-exact host reference and host fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "nice_ref.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB = os.path.join(_BUILD_DIR, "libniceref.so")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-std=c++17",
        "-fopenmp",
        "-shared",
        "-fPIC",
        _SRC,
        "-o",
        tmp,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)  # atomic: a concurrent loader never sees half a file


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB)
        lib.nice_encode.restype = ctypes.c_int64
        lib.nice_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.nice_decode.restype = ctypes.c_int64
        lib.nice_decode.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
        lib.nice_read_header.restype = ctypes.c_int32
        lib.nice_read_header.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.nice_free.restype = None
        lib.nice_free.argtypes = [ctypes.c_void_p]
        lib.nice_code_lengths.restype = None
        lib.nice_code_lengths.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib.nice_encode_batch.restype = ctypes.c_int64
        lib.nice_encode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.nice_decode_batch.restype = ctypes.c_int64
        lib.nice_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return lib


def encode_native(img: np.ndarray) -> bytes:
    """Serial C++ encode: (H, W, 3) uint8 -> .nice bytes."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, 3) uint8 image")
    if img.shape[1] < 4:
        raise ValueError("width must be >= 4 (SURVEY A.8.7)")
    lib = get_lib()
    img = np.ascontiguousarray(img)
    out_ptr = ctypes.c_void_p()
    n = lib.nice_encode(
        img.ctypes.data_as(ctypes.c_void_p),
        img.shape[1],
        img.shape[0],
        ctypes.byref(out_ptr),
    )
    if n < 0:
        raise ValueError(f"nice_encode failed: {n}")
    try:
        return ctypes.string_at(out_ptr, n)
    finally:
        lib.nice_free(out_ptr)


def decode_native(data: bytes) -> np.ndarray:
    """Serial C++ decode: .nice bytes -> (H, W, 3) uint8."""
    lib = get_lib()
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    ch = ctypes.c_uint8()
    if lib.nice_read_header(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch)) != 0:
        raise ValueError("truncated .nice header")
    if ch.value != 3:
        raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    rc = lib.nice_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"nice_decode failed: {rc}")
    return out


def encode_batch_native(imgs: list[np.ndarray]) -> list[bytes]:
    """OpenMP parallel batch encode (mixed sizes allowed)."""
    lib = get_lib()
    n = len(imgs)
    imgs = [np.ascontiguousarray(im) for im in imgs]
    for im in imgs:
        if im.ndim != 3 or im.shape[2] != 3 or im.dtype != np.uint8:
            raise ValueError("expected (H, W, 3) uint8 images")
        if im.shape[1] < 4:
            raise ValueError("width must be >= 4 (SURVEY A.8.7)")
    img_ptrs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p).value for im in imgs]
    )
    ws = (ctypes.c_uint32 * n)(*[im.shape[1] for im in imgs])
    hs = (ctypes.c_uint32 * n)(*[im.shape[0] for im in imgs])
    out_bufs = (ctypes.c_void_p * n)()
    out_lens = (ctypes.c_int64 * n)()
    rc = lib.nice_encode_batch(img_ptrs, ws, hs, n, out_bufs, out_lens)
    results = []
    try:
        for i in range(n):
            if out_lens[i] < 0:
                raise ValueError(f"nice_encode failed for image {i}: {out_lens[i]}")
            results.append(ctypes.string_at(out_bufs[i], out_lens[i]))
    finally:
        for i in range(n):
            if out_bufs[i]:
                lib.nice_free(out_bufs[i])
    if rc != 0 and len(results) != n:
        raise ValueError("batch encode failed")
    return results


def decode_batch_native(datas: list[bytes]) -> list[np.ndarray]:
    """OpenMP parallel batch decode."""
    lib = get_lib()
    n = len(datas)
    outs = []
    dims = []
    for d in datas:
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        ch = ctypes.c_uint8()
        if lib.nice_read_header(d, len(d), ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch)) != 0:
            raise ValueError("truncated .nice header")
        if ch.value != 3:
            raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
        outs.append(np.empty((h.value, w.value, 3), dtype=np.uint8))
        dims.append((h.value, w.value))
    bufs = [ctypes.create_string_buffer(d, len(d)) for d in datas]
    data_ptrs = (ctypes.c_void_p * n)(
        *[ctypes.cast(b, ctypes.c_void_p).value for b in bufs]
    )
    lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    out_ptrs = (ctypes.c_void_p * n)(
        *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs]
    )
    rcs = (ctypes.c_int64 * n)()
    lib.nice_decode_batch(data_ptrs, lens, n, out_ptrs, rcs)
    for i in range(n):
        if rcs[i] != 0:
            raise ValueError(f"nice_decode failed for item {i}: {rcs[i]}")
    return outs


def code_lengths_native(counts: np.ndarray) -> np.ndarray:
    """Deterministic Huffman lengths via C++ (identical to format.huffman)."""
    lib = get_lib()
    counts = np.ascontiguousarray(counts, dtype=np.uint64)
    out = np.zeros(counts.shape[0], dtype=np.uint8)
    lib.nice_code_lengths(
        counts.ctypes.data_as(ctypes.c_void_p),
        counts.shape[0],
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out
