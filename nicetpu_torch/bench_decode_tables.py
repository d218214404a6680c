"""What the decode tables cost the host and the device, on the card.

    python3 -m nicetpu_torch.bench_decode_tables [--reps R] [--host-only]

On the lengths of 8 `make_image` 512x512 images as the round trip's fused
encode gives them (int32, resident on the card), one JSON line `host`:
  * `call_us`: host microseconds of one call of the tables without a sync,
    all ten of them (`decode3.prepare_tables_v3(lens, walk=True)`; on a
    checkout without `walk=`, `prepare_tables_v3` then `derive_walk_tables`),
    median of R calls; and its parts, each timed by a wrapper around it
    during R more calls: the input checks, `torch.empty` and
    `torch.empty_like`, `build.load()`, `torch.cuda.current_stream`, the
    ctypes calls into the tables' C entries, the launch counts and the
    views of the one buffer (`cuda_ops._carve_tables`, where there is one);
    `other_us` is the rest (the wrappers' own cost included);
  * `kernel_ms`: that call's device time, CUDA events around 20 calls after
    a head start of about 10 ms (more calls would outlast it and time the
    host's pace);
  * `launches`: the launch counts of one call;
  * `tables_ms`, `walk_round1_ms`: the round trip's `tables` and
    `walk_round1` stages (`decode3._roundtrip_verify_core` with stage marks,
    the card idle before each call), median of R / 10.
The `host` line uses only what every version of the tables has, so two
checkouts compare in one run: `PYTHONPATH=<checkout> python3
<this file> --host-only`.

Then (unless --host-only) one JSON line `kernel` a variant, each built by
nvcc with the library's flags from an edited copy of
`csrc/decode_tables_kernels.cu` into `_build/decode_tables_ablation/` and
timed in turns (the committed source first and last) at B = 1, 8 and 32
with and without the walk's tables (CUDA events around R launches):
  committed        the kernel as it stands: one block an image, one warp a
                   chunk;
  staged_lengths   the lengths staged in shared memory by one block-wide
                   pass and a barrier before the counting;
  stream_blocks    (tables_ok not reduced: exact on valid lengths only)
                   a grid of (B, 10) blocks, one a stream, 11 warps each;
each exact or not against the plain versions; and one line `empty`: an
empty kernel launched the same way, with 1 block of 32 threads and with
B blocks of the committed kernel's 928 threads, the floor no launch beats.
Every line carries the card's name and power limit; exits non-zero without
a card or where a variant that should be exact is not.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

from nicetpu_torch.bench import card_line, make_image

SIDE, BATCH = 512, 8
SIZES = (1, 8, 32)
KERNEL_REPS = 20  # calls timed by CUDA events in the host line, well inside cuda_ms's head start
TABLES_THREADS = 29 * 32  # the committed kernel's block: one warp a chunk
EMPTY_SOURCE = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int nt_empty(int blocks, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""

KERNEL_HEAD = "  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;  // the warp's chunk\n"
LOAD = "    const long long raw = (long long)lens[img * nt::kSymbols + base + p];\n"
# variant -> (edits as (old, new) pairs, whether its outputs must be exact on every input)
VARIANTS = {
    "committed": ((), True),
    "staged_lengths": (
        ((KERNEL_HEAD, KERNEL_HEAD + "  __shared__ long long s_len[nt::kSymbols];\n"
                                     "  for (int i = threadIdx.x; i < nt::kSymbols; i += kTablesThreads)\n"
                                     "    s_len[i] = (long long)lens[(long long)blockIdx.x * nt::kSymbols + i];\n"
                                     "  __syncthreads();\n"),
         (LOAD, "    const long long raw = s_len[base + p];\n")),
        True),
    "stream_blocks": (
        (("constexpr int kTablesThreads = kChunks * kLanes;", "constexpr int kTablesThreads = 11 * kLanes;"),
         ("__shared__ int s_at[kChunks][kLanes];", "__shared__ int s_at[kChunks + 11][kLanes];"),
         (KERNEL_HEAD, "  const int c = kFirstChunk[blockIdx.y] + threadIdx.x / kLanes, lane = threadIdx.x % kLanes;\n"),
         ("const int s = kChunkStream[c], n", "const int s = blockIdx.y, n"),
         ("  if (c < kStreams) {\n    const int st = c;", "  if (threadIdx.x < kLanes) {\n    const int st = s;"),
         ("const dim3 grid(B);", "const dim3 grid(B, kStreams);")),
        False),
}


class Timed:
    """A callable that adds each call's host seconds to `self.seconds`."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, 0.0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0


def cuda_ms(fn, reps: int) -> float:
    """Mean ms a call over `reps` calls after a warm-up, by CUDA events; the
    stream first spins about 10 ms so that the launches queue ahead."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _build(name: str, source: str, out_dir: str) -> ctypes.CDLL:
    from nicetpu_torch.kernels import build

    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source)
    shutil.copy(os.path.join(build.CSRC, "common.cuh"), out_dir)
    lib = os.path.join(out_dir, f"lib{name}.so")
    res = subprocess.run([build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                          "-o", lib, src], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(os.path.abspath(lib))


def variant_source(name: str) -> str:
    """The kernel source with the variant's edits; each edit must apply once."""
    from nicetpu_torch.kernels import build

    with open(os.path.join(build.CSRC, "decode_tables_kernels.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit no longer applies to decode_tables_kernels.cu: {old!r}")
        src = src.replace(old, new)
    return src


def empty_launch_ms(dev, reps: int = 20) -> dict:
    """An empty kernel's device ms a launch through ctypes, at one block of
    32 threads and at B blocks of TABLES_THREADS for B in SIZES."""
    from nicetpu_torch.kernels import build

    lib = _build("empty", EMPTY_SOURCE, os.path.join(build.BUILD_DIR, "launch_floor"))
    lib.nt_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.nt_empty.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def launcher(blocks, threads):
        def call():
            if lib.nt_empty(blocks, threads, dev.index or 0, stream):
                raise RuntimeError("the empty kernel did not launch")
        return call

    out = {"1x32": cuda_ms(launcher(1, 32), reps)}
    out.update({f"{b}x{TABLES_THREADS}": cuda_ms(launcher(b, TABLES_THREADS), reps) for b in SIZES})
    return out


def main_lengths(dev, n: int = BATCH) -> torch.Tensor:
    """(n, 858) int32 lengths of make_image(512, 512, s), s < n, from the fused encode."""
    from nicetpu_torch import pipeline
    from nicetpu_torch.kernels.encode2 import encode_fused_core
    from nicetpu_torch.kernels.geometry import Geometry

    flat = pipeline.upload_batch([make_image(SIDE, SIDE, s) for s in range(n)], dev)
    geom = Geometry.uniform(SIDE, SIDE * SIDE, n, dev)
    return encode_fused_core(flat, geom=geom, ndigits_cap=3, w_cap=pipeline.w_cap(SIDE * SIDE))[1]


def tables_call():
    """One call of all ten tables as this checkout makes it."""
    from nicetpu_torch.kernels import decode3

    if "walk" in inspect.signature(decode3.prepare_tables_v3).parameters:
        return lambda lens: decode3.prepare_tables_v3(lens, walk=True)
    return lambda lens: decode3.derive_walk_tables(*decode3.prepare_tables_v3(lens)[:3])


def call_parts(call, lens, reps: int) -> dict:
    """Host us a call of each part of `call` (see the module's docstring)."""
    from nicetpu_torch.kernels import build, cuda_ops

    lib = build.load()
    patches = [(cuda_ops, n) for n in ("check", "check_per_symbol", "same_device", "count_launch", "_carve_tables")
               if hasattr(cuda_ops, n)]
    patches += [(torch, "empty"), (torch, "empty_like"), (build, "load"), (torch.cuda, "current_stream")]
    patches += [(lib, n) for n in ("nt_decode_tables", "nt_walk_tables")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in patches]
    timers = {}
    for obj, name, fn in saved:
        timers[name] = Timed(fn)
        setattr(obj, name, timers[name])
    whole = 0.0
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(lens)
            whole += time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    parts = {k: t.seconds / reps * 1e6 for k, t in timers.items()}
    groups = {"checks": ("check", "check_per_symbol", "same_device"), "torch_empty": ("empty", "empty_like"),
              "build_load": ("load",), "current_stream": ("current_stream",),
              "ctypes": ("nt_decode_tables", "nt_walk_tables"), "count": ("count_launch",),
              "views": ("_carve_tables",)}
    out = {f"{g}_us": sum(parts.get(n, 0.0) for n in names) for g, names in groups.items()}
    out["other_us"] = whole / reps * 1e6 - sum(out.values())
    return out


def host_us(call, lens, reps: int) -> float:
    """Median host microseconds of one call without a sync, the card idle before it."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(lens)
        out.append(time.perf_counter() - t0)
    return statistics.median(out) * 1e6


def stage_ms(dev, reps: int) -> dict:
    """Median ms of the round trip's `tables` and `walk_round1` stages."""
    from nicetpu_torch import pipeline
    from nicetpu_torch.kernels import decode3
    from nicetpu_torch.kernels.encode2 import mark_stage
    from nicetpu_torch.kernels.geometry import Geometry

    flat = pipeline.upload_batch([make_image(SIDE, SIDE, s) for s in range(BATCH)], dev)
    kw = dict(geom=Geometry.uniform(SIDE, SIDE * SIDE, BATCH, dev), ndigits_cap=3,
              w_cap=decode3.roundtrip_cap_words(SIDE * SIDE), cfg=decode3.LADDER[0])
    got: dict = {"tables": [], "walk_round1": []}
    for _ in range(reps + 1):  # the first call warms up
        torch.cuda.synchronize()
        marks: list = []
        mark_stage(marks, "start")
        decode3._roundtrip_verify_core(flat, marks=marks, **kw)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            if name in got:
                got[name].append(a.elapsed_time(b))
    return {f"{k}_ms": statistics.median(v[1:]) for k, v in got.items()}


def host_line(dev, reps: int) -> dict:
    from nicetpu_torch.kernels import cuda_ops

    lens = main_lengths(dev)
    call = tables_call()
    call(lens)
    cuda_ops.reset_launches()
    call(lens)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_ops.LAUNCHES.items() if v}
    return {"line": "host", "call_us": host_us(call, lens, reps), **call_parts(call, lens, reps),
            "kernel_ms": cuda_ms(lambda: call(lens), KERNEL_REPS),
            "launches": launches, **stage_ms(dev, max(reps // 10, 5)), "card": card_line()}


def kernel_lines(dev, reps: int) -> list[dict]:
    from nicetpu_torch.kernels import build, cuda_ops, decode3

    lens32 = main_lengths(dev, max(SIZES))
    want = {b: decode3.prepare_tables_v3_plain(lens32[:b]) for b in SIZES}
    want = {b: w + decode3.derive_walk_tables_plain(*w[:3]) for b, w in want.items()}
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    lines = []
    for name in [*VARIANTS, "committed"]:
        lib = _build("decode_tables", variant_source(name), os.path.join(build.BUILD_DIR, "decode_tables_ablation", name))
        fn = lib.nt_decode_tables
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        line = {"line": "kernel", "variant": name, "ms": {}, "ms_without_walk": {}, "exact": {}, "card": card_line()}
        for b in SIZES:
            lens = lens32[:b].contiguous()
            bufs = {w: torch.empty(cuda_ops._table_layout(b, w)[2], dtype=torch.bool, device=dev)
                    for w in (True, False)}

            def launcher(walk):
                def call():
                    if fn(lens.data_ptr(), 0, bufs[walk].data_ptr(), int(walk), b, dev.index or 0, stream):
                        raise RuntimeError(f"{name}: the launch failed")
                return call

            line["ms"][b] = cuda_ms(launcher(True), reps)
            line["ms_without_walk"][b] = cuda_ms(launcher(False), reps)
            got = cuda_ops._carve_tables(bufs[True], b, True)
            line["exact"][b] = all(torch.equal(g, w) for g, w in zip(got, want[b]))
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--host-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_decode_tables needs a CUDA device", file=sys.stderr)
        return 1
    from nicetpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    build.load()
    print(json.dumps(host_line(dev, args.reps)), flush=True)
    if args.host_only:
        return 0
    lines = kernel_lines(dev, min(args.reps, 50))
    print(json.dumps({"line": "empty", "ms": empty_launch_ms(dev), "card": card_line()}), flush=True)
    failed = [ln["variant"] for ln in lines if VARIANTS[ln["variant"]][1] and not all(ln["exact"].values())]
    if failed:
        print(f"not exact: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
