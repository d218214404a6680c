"""What one tokenizer call costs the host and the device: one JSON line.

    python3 -m nicetpu_torch.bench_tokenize_host [--reps R]

On 8 `make_image` 512x512 images, resident on the card, at 3 run digits:
  * `stage_ms`: the fused encode's `tokenize` stage as the round trip's
    stage marks read it (CUDA events, the device idle before the call, so
    the host's time to issue the call shows), median of R;
  * `call_us`: host microseconds of one `tokenize.tokenize_bins` call with
    no sync (median of R), and its parts, each timed by a wrapper around
    it during R more calls: the input checks (`_check_tokenize`), every
    `torch.empty`, every `build.load()` and every ctypes call into the
    tokenizer's C entries; `other_us` is the rest of the call (the
    wrappers' own cost included);
  * `kernel_ms`: the call's device time, CUDA events around R calls.
The script uses only what every version of the tokenizer's wrapper has, so
that two checkouts can be compared in one run (`PYTHONPATH=<checkout>`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from nicetpu_torch import pipeline
from nicetpu_torch.bench import card_line, make_image
from nicetpu_torch.kernels import build, encode2
from nicetpu_torch.kernels import tokenize as tok

SIDE, BATCH = 512, 8
C_ENTRIES = ("nt_tokenize_bins", "nt_tokenize_tiles", "nt_first_change")


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


def stage_ms(flat, reps: int) -> float:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        marks: list = []
        encode2.mark_stage(marks, "start")
        encode2.encode_fused_core(flat, width=SIDE, ndigits_cap=3, w_cap=pipeline.w_cap(SIDE * SIDE), marks=marks)
        torch.cuda.synchronize()
        names = [name for name, _ in marks]
        i = names.index("tokenize")
        out.append(marks[i - 1][1].elapsed_time(marks[i][1]))
    return statistics.median(out)


def call_parts(flat, kw, reps: int) -> dict:
    whole = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok.tokenize_bins(flat, **kw)
        whole.append(time.perf_counter() - t0)
    lib = build.load()
    timers = {"checks": Timed(tok._check_tokenize), "torch_empty": Timed(torch.empty), "build_load": Timed(build.load)}
    entries = {name: Timed(getattr(lib, name)) for name in C_ENTRIES if hasattr(lib, name)}
    saved = (tok._check_tokenize, torch.empty, build.load)
    tok._check_tokenize, torch.empty, build.load = timers["checks"], timers["torch_empty"], timers["build_load"]
    for name, t in entries.items():
        setattr(lib, name, t)
    patched = 0.0
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok.tokenize_bins(flat, **kw)
            patched += time.perf_counter() - t0
    finally:
        tok._check_tokenize, torch.empty, build.load = saved
        for name, t in entries.items():
            setattr(lib, name, t.fn)
    parts = {k: t.seconds / reps * 1e6 for k, t in timers.items()}
    parts["ctypes"] = sum(t.seconds for t in entries.values()) / reps * 1e6
    parts["other"] = patched / reps * 1e6 - sum(parts.values())
    return {"call_us": statistics.median(whole) * 1e6, **{f"{k}_us": v for k, v in parts.items()},
            "c_entries": sorted(entries)}


def kernel_ms(flat, kw, reps: int) -> float:
    for _ in range(2):
        tok.tokenize_bins(flat, **kw)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # the host queues the calls ahead of the device
    start.record()
    for _ in range(reps):
        tok.tokenize_bins(flat, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_tokenize_host needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    build.load()
    flat = pipeline.upload_batch([make_image(SIDE, SIDE, s) for s in range(BATCH)], dev)
    kw = dict(width=SIDE, halo=0, g0=0, n_total=SIDE * SIDE, ndigits_cap=3, invalid_bin=encode2.INVALID_BIN)
    out = {"stage_ms": stage_ms(flat, max(args.reps // 10, 5)), **call_parts(flat, kw, args.reps),
           "kernel_ms": kernel_ms(flat, kw, args.reps), "card": card_line()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
