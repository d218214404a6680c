"""A device trace of the round trip, split by operation: one JSON line
(counterpart of `bench_trace.py`).

    python3 -m nicetpu_torch.bench_trace [--reps R] [--device cuda|cpu]

`torch.profiler`, with CUDA activity, records one warm
`pipeline.roundtrip_batch_resident` of 8 resident `make_image` 512x512
images inside a named range, the window.  The line holds the ten device
operations that took the most time (name, total ms, count), the device's
busy time (the union of the device operations' intervals inside the
window) and its idle share, 1 - busy / window.  Beside the traced window,
`untraced_ms` is the median of `reps` untraced calls of the same round
trip, so that what the profiler itself costs on the host shows.  On the
CPU (device="cpu", for tests) the operations are the host's, by self
time, and the idle share is null.  Every round trip must be verified on
the device; the process exits non-zero otherwise.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from nicetpu_torch.bench import BATCH, SIDE, card_line, make_image, prepare, require, sync

WINDOW = "nicetpu_roundtrip_window"
TOP = 10
REPS = 3
NAME_CHARS = 120  # kernel names are cut to this many characters


def union_ms(intervals, lo: float, hi: float) -> float:
    """Total length of the union of (start, end) intervals clipped to
    [lo, hi], in the intervals' unit."""
    total, reach = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        a = max(a, reach)
        if b > a:
            total += b - a
            reach = b
    return total


def idle_share(intervals, lo: float, hi: float) -> float:
    """1 - (union of the intervals inside [lo, hi]) / (hi - lo)."""
    return 1.0 - union_ms(intervals, lo, hi) / (hi - lo)


def top_ops(rows, n: int = TOP) -> list[dict]:
    """rows of (name, ms): the n names of the largest total, with counts."""
    agg: dict = {}
    for name, ms in rows:
        tot, cnt = agg.get(name, (0.0, 0))
        agg[name] = (tot + ms, cnt + 1)
    best = sorted(agg.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:NAME_CHARS], "total_ms": t, "count": c} for k, (t, c) in best]


def run(device="cuda", *, batch: int = BATCH, side: int = SIDE, reps: int = REPS,
        card: str | None = None) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from nicetpu_torch import pipeline

    dev = prepare(device)
    imgs = [make_image(side, side, s) for s in range(batch)]
    flat = pipeline.upload_batch(imgs, dev)

    def rt():
        _, verified = pipeline.roundtrip_batch_resident(flat, imgs)
        require(bool(verified.all()), f"round trip not verified on the device: {verified.tolist()}")

    rt()  # warm-up
    untraced = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        rt()
        sync(dev)
        untraced.append((time.perf_counter() - t0) * 1e3)
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync(dev)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            rt()
            sync(dev)
    events = prof.events()
    win = next(e for e in events if e.name == WINDOW)
    lo, hi = win.time_range.start, win.time_range.end  # microseconds
    out = {"trace": f"pipeline.roundtrip_batch_resident, {batch} x {side}x{side} RGB8, warm",
           "window_ms": (hi - lo) / 1e3, "untraced_ms": statistics.median(untraced),
           "untraced_ms_fastest": min(untraced), "untraced_ms_slowest": max(untraced)}
    if cuda:
        # the window's own range is mirrored on the device as an annotation
        on_dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name != WINDOW]
        require(bool(on_dev), "the trace holds no device operation")
        spans = [(e.time_range.start, e.time_range.end) for e in on_dev]
        out["device_ops"] = len(on_dev)
        out["device_busy_ms"] = union_ms(spans, lo, hi) / 1e3
        out["device_idle_share"] = idle_share(spans, lo, hi)
        out["top_device_ops"] = top_ops((e.name, (e.time_range.end - e.time_range.start) / 1e3)
                                        for e in on_dev)
    else:
        out["device_idle_share"] = None
        out["top_host_ops"] = [{"name": a.key[:NAME_CHARS], "total_ms": a.self_cpu_time_total / 1e3,
                                "count": a.count}
                               for a in sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
                               if a.key != WINDOW][:TOP]
    out.update(reps=reps, device=str(dev), card=card if card is not None else card_line())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the trace runs on the card", file=sys.stderr)
        return 1
    print(json.dumps(run(args.device, reps=args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
