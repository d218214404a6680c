"""The real-photo bench: ratios, throughput and the fused encode's fast-path
coverage on the corpus of `nicetpu_torch.realcorpus` (counterpart of
`bench_real.py`).

    python3 -m nicetpu_torch.bench_real [--max-dim D] [--reps R] [--device cuda|cpu]

One JSON line an image of `load_corpus(max_dim=1024)`: the compression
ratio, the native round trip MB/s (`hostref` encode + decode), the device
encode MB/s of the fused encode (`encode2.encode_fused` at the image's
shape, its small array fetched), `device_fastpath` (the encode did not set
its overflow flag, `small[:, 859]`; where it did, the native encoder takes
the image on the card's path) and, on the fast path, `bits_match` (the
fused total equals the native stream's payload size).  The last line sums
up: `overall_ratio` and `device_fastpath_rate`.  Times are the median of
`reps` repeats after a warm-up, with the fastest and the slowest beside
them; `card` is nvidia-smi's name and power limit.  A native round trip
that differs raises and a `bits_match` of false exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from nicetpu_torch.bench import card_line, prepare, rates, require, timed

MAX_DIM = 1024
REPS = 3


def image_line(name: str, img: np.ndarray, dev: torch.device, *, reps: int,
               card: str) -> tuple[dict, int]:
    """One image's line (see the module docstring) and its `.nice` bytes."""
    from nicetpu_torch import pipeline
    from nicetpu_torch.format import constants as C
    from nicetpu_torch.hostref import oracle
    from nicetpu_torch.kernels.encode2 import encode_fused
    from nicetpu_torch.kernels.geometry import Geometry

    H, W, _ = img.shape
    mb = img.nbytes / 1e6
    data = oracle.encode_native(img)
    outs, secs = timed(lambda: oracle.decode_native(oracle.encode_native(img)), reps, dev)
    require(all(np.array_equal(o, img) for o in outs), f"{name}: the native round trip differs")
    rec = {"image": name, "shape": f"{H}x{W}", "ratio": img.nbytes / len(data)}
    rec.update(rates("native_rt_mbs", mb, secs))

    flat = pipeline.upload_batch([img], dev)
    cap = pipeline.w_cap(H * W)
    geom = Geometry.uniform(W, H * W, 1, dev)

    def enc():
        return encode_fused(flat, geom=geom, ndigits_cap=3, w_cap=cap)[1].cpu().numpy()

    enc()  # warm-up
    outs, secs = timed(enc, reps, dev)
    rec.update(rates("device_enc_mbs", mb, secs))
    small = outs[-1]
    rec["device_fastpath"] = not bool(small[0, 859])
    if rec["device_fastpath"]:
        payload_bits = (len(data) - C.FILE_HEADER_BYTES - C.STREAM_HEADERS_BYTES - 5) * 8
        rec["bits_match"] = abs(payload_bits - int(small[0, 858])) < 8
    rec.update(reps=reps, card=card)
    return rec, len(data)


def run(device="cuda", *, max_dim: int = MAX_DIM, reps: int = REPS,
        card: str | None = None) -> list[dict]:
    """Every image's line, then the summary, each printed as it comes and
    returned."""
    from nicetpu_torch.realcorpus import load_corpus

    dev = prepare(device)
    card = card if card is not None else card_line()
    corpus = load_corpus(max_dim=max_dim)
    lines, raw, nice, fast = [], 0, 0, 0
    for name, img in corpus:
        rec, nbytes = image_line(name, img, dev, reps=reps, card=card)
        raw += img.nbytes
        nice += nbytes
        fast += rec["device_fastpath"]
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    summary = {"summary": "real-photo corpus", "images": len(corpus), "overall_ratio": raw / nice,
               "device_fastpath_rate": fast / max(len(corpus), 1), "card": card}
    print(json.dumps(summary), flush=True)
    return lines + [summary]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-dim", type=int, default=MAX_DIM, help="centre-crop each image to this side")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the bench runs on the card", file=sys.stderr)
        return 1
    lines = run(args.device, max_dim=args.max_dim, reps=args.reps)
    bad = [ln["image"] for ln in lines[:-1] if ln.get("bits_match") is False]
    if bad:
        print(f"bits_match is false for {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
