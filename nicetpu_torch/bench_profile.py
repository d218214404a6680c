"""Stage profile of the fused encode as the batch grows (counterpart of
`bench_profile.py`).

    python3 -m nicetpu_torch.bench_profile [--sizes 8 16 32] [--side S] [--reps R] [--device cuda|cpu]

For each batch size B, B `make_image` side x side images (512x512 by
default), uploaded once (untimed), go through
  dispatch        `encode2.encode_fused(flat, geom, ndigits_cap=3,
                  w_cap=pipeline.w_cap(N))` and the fetch of the (B, 860)
                  small array: the tokenizer, the histogram kernel, the
                  device Huffman tables, the table-join and fold kernels
                  and the place;
  payload fetch   words[:, :kmax] to the host, kmax = max(total) // 32 + 2;
  assembly        the headers and `bitpack.words_to_payload`, image by image;
  native decode   `hostref.decode_batch_native` of the B blobs.
One JSON line a batch size, with the keys of the JAX script: `B`, `raw_mb`,
`comp_mb`, `dispatch_ms`, `dispatch_mbs`, `payload_fetch_ms`, `fetched_mb`,
`fetch_mbs_wire`, `assemble_ms`, `native_batch_decode_ms`, `decode_mbs`.
Each time is the median of `reps` repeats after a warm-up, with the fastest
and the slowest beside it (`*_fastest`, `*_slowest`); each rate is taken at
the median.  MB is 10**6 bytes of raw RGB8 (`fetched_mb`: the words
fetched).  On the card every timed region ends in a synchronize.  `side`,
`reps`, `device` and `card` (nvidia-smi's name and power limit) close the
line.  The process exits non-zero where the fused encode overflows, where a
blob differs from `hostref.encode_native`'s, or where the native decode
does not return every image.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from nicetpu_torch.bench import card_line, make_image, prepare, require, stage_ms, timed

SIZES = (8, 16, 32)
SIDE = 512
REPS = 3


def batch_line(B: int, dev: torch.device, *, side: int, reps: int, card: str) -> dict:
    """One batch size's line (see the module docstring)."""
    from nicetpu_torch import pipeline
    from nicetpu_torch.convert import words_to_numpy
    from nicetpu_torch.format import headers
    from nicetpu_torch.hostref import oracle
    from nicetpu_torch.kernels import encode2
    from nicetpu_torch.kernels.bitpack import words_to_payload
    from nicetpu_torch.kernels.geometry import Geometry

    imgs = [make_image(side, side, s) for s in range(B)]
    refs = [oracle.encode_native(im) for im in imgs]
    flat = pipeline.upload_batch(imgs, dev)
    cap = pipeline.w_cap(side * side)
    mb = sum(im.nbytes for im in imgs) / 1e6
    geom = Geometry.uniform(side, side * side, B, dev)

    def dispatch():
        words, small = encode2.encode_fused(flat, geom=geom, ndigits_cap=3, w_cap=cap)
        return words, small.cpu().numpy()

    secs: dict = {}
    dispatch()  # warm-up
    outs, secs["dispatch"] = timed(dispatch, reps, dev)
    words_d, small = outs[-1]
    require(not small[:, 859].any(), f"B={B}: the fused encode overflowed: {small[:, 859].tolist()}")
    totals = small[:, 858].astype(np.int64)
    kmax = min(int(totals.max()) // 32 + 2, int(words_d.shape[1]))

    def fetch():
        return words_to_numpy(words_d[:, :kmax].contiguous())

    fetch()
    outs, secs["payload_fetch"] = timed(fetch, reps, dev)
    words = outs[-1]
    file_hdr = headers.pack_file_header(side, side, 3)

    def assemble():
        return [file_hdr + headers.pack_stream_headers(small[b, :858].astype(np.uint8))
                + words_to_payload(words[b], int(totals[b])) for b in range(B)]

    outs, secs["assemble"] = timed(assemble, reps, torch.device("cpu"))
    blobs = outs[-1]
    require(blobs == refs, f"B={B}: a blob differs from hostref.encode_native")

    outs, secs["native_batch_decode"] = timed(lambda: oracle.decode_batch_native(blobs), reps,
                                              torch.device("cpu"))
    require(all(len(o) == B and all(np.array_equal(a, im) for a, im in zip(o, imgs)) for o in outs),
            f"B={B}: the native batch decode did not return every image")

    fetched_mb = B * kmax * 4 / 1e6
    med = {k: statistics.median(v) for k, v in secs.items()}
    line: dict = {"B": B, "raw_mb": mb, "comp_mb": sum(len(b) for b in blobs) / 1e6,
                  "dispatch_mbs": mb / med["dispatch"], "fetched_mb": fetched_mb,
                  "fetch_mbs_wire": fetched_mb / med["payload_fetch"],
                  "decode_mbs": mb / med["native_batch_decode"]}
    for k, v in secs.items():
        line.update(stage_ms(k, v))
    line.update(side=side, reps=reps, device=str(dev), card=card)
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
