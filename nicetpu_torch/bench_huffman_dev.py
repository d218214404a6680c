"""Huffman tables built on the device against tables built on the host: the
fused encode and the two-step encode of the same resident batches
(counterpart of `bench_huffman_dev.py`).

    python3 -m nicetpu_torch.bench_huffman_dev [--sizes 1 4 8] [--side S] [--reps R] [--device cuda|cpu]

For each batch size B, B `make_image` side x side images (512x512 by
default), uploaded once (untimed), go through
  fused    `encode2.encode_fused`: tokenizer, histogram, the tables built on
           the device (`huffman_dev`, one launch of the `huffman_tables`
           kernel), join, fold and place; the (B, 860) small array
           fetched;
  twostep  `encode2.encode_resident`: `tokenize_compact` (tokenizer and
           histogram), the counts fetched, `build_tables_host` per image
           (the C++ code-length merge), the tables uploaded, `pack_compact`
           (join, fold and place); the totals fetched.
One JSON line a batch size: each path's milliseconds at the median of
`reps` repeats after a warm-up (the two paths take turns), with the
fastest and the slowest; MB/s of raw RGB8 (10**6 bytes) at the median, the
fastest and the slowest; each path's payload bits summed over the batch;
`device_tables_win` (the fused median is the shorter); `card`, nvidia-smi's
name and power limit.  The process exits non-zero where the two paths'
bits differ, where the fused encode overflows, or where either path's bytes
differ from `hostref.encode_native`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from nicetpu_torch.bench import card_line, make_image, prepare, rates, require, sync

SIZES = (1, 4, 8)
SIDE = 512
REPS = 5


def batch_line(B: int, dev: torch.device, *, side: int, reps: int, card: str) -> dict:
    """One batch size's line (see the module docstring)."""
    from nicetpu_torch import pipeline
    from nicetpu_torch.hostref import oracle
    from nicetpu_torch.kernels import encode2
    from nicetpu_torch.kernels.geometry import Geometry

    imgs = [make_image(side, side, s) for s in range(B)]
    refs = [oracle.encode_native(im) for im in imgs]
    flat = pipeline.upload_batch(imgs, dev)
    cap = pipeline.w_cap(side * side)
    geom = Geometry.uniform(side, side * side, B, dev)

    def fused():
        words, small = encode2.encode_fused(flat, geom=geom, ndigits_cap=3, w_cap=cap)
        return words, small.cpu().numpy()

    def twostep():
        return encode2.encode_resident(flat, width=side)

    paths = {"fused": fused, "twostep": twostep}
    outs = {name: fn() for name, fn in paths.items()}  # warm-up
    secs: dict = {name: [] for name in paths}
    for _ in range(reps):
        for name, fn in paths.items():
            sync(dev)
            t0 = time.perf_counter()
            outs[name] = fn()
            sync(dev)
            secs[name].append(time.perf_counter() - t0)

    words_f, small = outs["fused"]
    words_t, totals, lengths = outs["twostep"]
    require(not small[:, 859].any(), f"B={B}: the fused encode overflowed: {small[:, 859].tolist()}")
    fused_bits = small[:, 858].astype(np.int64)
    require(np.array_equal(fused_bits, totals),
            f"B={B}: payload bits differ: fused {fused_bits.tolist()}, twostep {totals.tolist()}")
    require(pipeline._assemble_payloads(words_f, small, imgs, None) == refs,
            f"B={B}: a fused blob differs from hostref.encode_native")
    require(encode2.assemble(words_t, totals, lengths, side, side) == refs,
            f"B={B}: a two-step blob differs from hostref.encode_native")

    mb = sum(im.nbytes for im in imgs) / 1e6
    line: dict = {"B": B, "side": side, "raw_mb": mb}
    for name, s in secs.items():
        line[f"{name}_ms"] = statistics.median(s) * 1e3
        line[f"{name}_ms_fastest"] = min(s) * 1e3
        line[f"{name}_ms_slowest"] = max(s) * 1e3
        line.update(rates(f"{name}_mb_s", mb, s))
    line.update(fused_bits=int(fused_bits.sum()), twostep_bits=int(totals.sum()),
                device_tables_win=line["fused_ms"] < line["twostep_ms"], reps=reps,
                device=str(dev), card=card)
    return line


def run(device="cuda", *, sizes=SIZES, side: int = SIDE, reps: int = REPS,
        card: str | None = None) -> list[dict]:
    """Every batch size's line, each printed as it comes and returned;
    raises on any unverified output."""
    dev = prepare(device)
    card = card if card is not None else card_line()
    lines = []
    for B in sizes:
        ln = batch_line(B, dev, side=side, reps=reps, card=card)
        print(json.dumps(ln), flush=True)
        lines.append(ln)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--side", type=int, default=SIDE)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the bench runs on the card", file=sys.stderr)
        return 1
    run(args.device, sizes=args.sizes, side=args.side, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
