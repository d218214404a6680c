#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA encode port (nicetpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one printed line or block each; any failure exits nonzero:
  0. the card's name and power limit (nvidia-smi); exit 1 without CUDA;
  1. build the CUDA kernels from csrc/ with nvcc, print the build time;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (exact equality) and time both with CUDA events;
  3. encode 64 512x512 RGB8 images in 8 batches of 8 through
     nicetpu_torch.encode_batch(device="cuda"); every blob must equal the
     native encoder's and decode back to its image, no image may fall back,
     and every kernel's launch count must rise with each batch; print MB/s
     and per-stage milliseconds;
  4. the same for one 4096x4096 RGB8 image.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import nicetpu_torch
from bench import make_image
from nicetpu.hostref import oracle
from nicetpu.spec import codec
from nicetpu_torch import pipeline
from nicetpu_torch.convert import from_int32_bits
from nicetpu_torch.kernels import build, cuda_ops

SOURCE = "nicetpu_torch/csrc/encode_kernels.cu"
REPLACES = {
    "histogram": "nicetpu/kernels/pallas_ops.py:100",
    "table_join": "nicetpu/kernels/pallas_ops.py:237",
    "fold_records": "nicetpu/kernels/pallas_ops.py:329",
}
# main path shapes: 8 images of 512x512, 8 token slots per pixel, 8 pixels a group
B, N = 8, 512 * 512
M, MG, S = N * 8, N // 8, 64


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return res.stdout.strip() or res.stderr.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest difference of the uint32 values the int32 tensors carry."""
    return int((from_int32_bits(got) - from_int32_bits(want)).abs().max())


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    rng = np.random.default_rng(0)
    bins = rng.integers(0, 858, (B, M), dtype=np.int32)
    bins[rng.random((B, M)) < 0.3] = 1023  # about 30 % holes
    lengths = rng.integers(1, 32, (B, 858), dtype=np.int32)
    codes = rng.integers(0, 2**32, (B, 858), dtype=np.uint64).astype(np.uint32)
    bins_d = torch.from_numpy(bins).to(dev)
    len_d = torch.from_numpy(lengths).to(dev)
    codes_d = torch.from_numpy(codes.view(np.int32)).to(dev)  # MSB set on half
    # the fold takes the join's output, shaped as on the main path
    aob_d, code_d = cuda_ops.table_join_plain(bins_d, len_d, codes_d)
    aob2, code2 = aob_d.view(B, MG, S), code_d.view(B, MG, S)

    results = {}
    cases = {
        "histogram": (lambda: cuda_ops.histogram(bins_d), lambda: cuda_ops.histogram_plain(bins_d), 20, 10),
        "table_join": (
            lambda: cuda_ops.table_join(bins_d, len_d, codes_d),
            lambda: cuda_ops.table_join_plain(bins_d, len_d, codes_d), 20, 10,
        ),
        "fold_records": (
            lambda: cuda_ops.fold_records(aob2, code2), lambda: cuda_ops.fold_records_plain(aob2, code2), 20, 3,
        ),
    }
    for name, (kern, plain, reps, plain_reps) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, plain_reps, warmup=1)
        print(f"[kernel] {name}: exact={same} max_abs_err={err} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms shapes={[tuple(g.shape) for g in got]}")
        check(same, f"{name} kernel disagrees with its plain version (max_abs_err {err})")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return results


def stage_ms(marks) -> dict:
    """Per-stage milliseconds from consecutive (name, event) marks."""
    out = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out


def phase_main_path(dev) -> dict:
    """64 x 512^2 images in 8 batches of 8 through the user entry point."""
    imgs = [make_image(512, 512, s) for s in range(64)]
    t0 = time.perf_counter()
    refs = [oracle.encode_native(im) for im in imgs]
    print(f"[main] native reference encodes: {time.perf_counter() - t0:.2f} s")
    nicetpu_torch.encode_batch(imgs[:8], device="cuda")  # warm-up, not counted
    torch.cuda.synchronize()

    stats: dict = {}
    per_batch = []
    cuda_ops.reset_launches()
    batch_ms = []
    blobs = []
    t0 = time.perf_counter()
    for i in range(0, 64, 8):
        tb = time.perf_counter()
        blobs += nicetpu_torch.encode_batch(imgs[i : i + 8], device="cuda", stats=stats)
        batch_ms.append((time.perf_counter() - tb) * 1e3)
        per_batch.append(dict(cuda_ops.LAUNCHES))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    mb = sum(im.nbytes for im in imgs) / 1e6
    print(f"[main] 64 x 512x512 RGB8 in 8 batches of 8: {seconds:.4f} s, "
          f"{mb / seconds:.2f} MB/s encode; batch ms median {np.median(batch_ms):.3f} "
          f"max {max(batch_ms):.3f} (8 batches); launches={launches}, stats={stats}")

    for name in launches:
        counts = [0] + [p[name] for p in per_batch]
        check(all(b > a for a, b in zip(counts, counts[1:])),
              f"{name} was not launched in every batch: {counts}")
    check(stats.get("overflow_fallbacks") == 0, f"overflow fallbacks: {stats}")
    check(all(b == r for b, r in zip(blobs, refs)), "a blob differs from the native encoder's")
    check(all(np.array_equal(oracle.decode_native(b), im) for b, im in zip(blobs, imgs)),
          "a blob does not decode to its image")
    check(codec.encode(imgs[0]) == blobs[0], "blob 0 differs from the spec encoder's")
    print(f"[main] 64/64 blobs equal hostref.encode_native, decode exactly, "
          f"blob 0 equals spec.codec.encode ({len(blobs[0])} bytes, ratio "
          f"{sum(im.nbytes for im in imgs) / sum(len(b) for b in blobs):.3f})")

    # per-stage times: the same 8 batches again, with CUDA event marks
    totals: dict = {}
    for i in range(0, 64, 8):
        marks: list = []
        out = pipeline.encode_batch_fused(imgs[i : i + 8], device=dev, marks=marks)
        check(out == refs[i : i + 8], "instrumented run differs")
        torch.cuda.synchronize()
        for k, v in stage_ms(marks).items():
            totals[k] = totals.get(k, 0.0) + v
    per = {k: round(v / 8, 4) for k, v in totals.items()}
    print(f"[main] per-stage ms per batch of 8 (CUDA events, mean of 8): {json.dumps(per)}")
    return launches


def phase_big(dev) -> None:
    """One 4096x4096 RGB8 image."""
    img = make_image(4096, 4096, 99)
    ref = oracle.encode_native(img)
    nicetpu_torch.encode_batch([img], device="cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    t0 = time.perf_counter()
    blob = nicetpu_torch.encode_batch([img], device="cuda", stats=stats)[0]
    seconds = time.perf_counter() - t0
    check(blob == ref, "4096^2 blob differs from the native encoder's")
    check(np.array_equal(oracle.decode_native(blob), img), "4096^2 blob does not decode")
    check(stats.get("overflow_fallbacks") == 0, f"4096^2 overflow fallback: {stats}")
    marks: list = []
    pipeline.encode_batch_fused([img], device=dev, marks=marks)
    torch.cuda.synchronize()
    per = {k: round(v, 4) for k, v in stage_ms(marks).items()}
    print(f"[big] 4096x4096 RGB8: {seconds:.4f} s, {img.nbytes / 1e6 / seconds:.2f} MB/s encode, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"blob equals native and decodes exactly; per-stage ms {json.dumps(per)}")


def main() -> int:
    print(card_line())
    if not torch.cuda.is_available():
        print("[card] torch.cuda.is_available() is false: nothing to run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    seconds, log = build.build()
    build.load()
    print(f"[build] nvcc build {seconds:.2f} s\n{log.strip()}")

    kernels = phase_kernels(dev)
    launches = phase_main_path(dev)
    phase_big(dev)

    record = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], **kernels[name]}
        for name in REPLACES
    ]
    print(card_line())
    print(json.dumps({"kernels": record}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
