"""Stage profile of the device decode core (counterpart of
`bench_decode_profile.py`).

    python3 -m nicetpu_torch.bench_decode_profile [--batch B] [--side S] [--reps R] [--device cuda|cpu]

B `make_image` side x side images (8 of 512x512 by default) are encoded by
`hostref.encode_native`, and their streams decoded on the fast rung
(`decode3.LADDER[0]`) in stages, each timed on its own:
  prep_host_ms          `decode3.prepare_batch_args`: headers parsed and
                        validated and the payload words packed on the host,
                        then the words and lengths uploaded and the decode
                        tables built on the device;
  word_blocks_ms        null: the port has no word staging pass (the JAX
                        `make_word_blocks`); the walk kernel stages each
                        block's words into shared memory itself;
  walk1_ms              one `decode3.walk` round from the chunk starts, with
                        its records: the walk kernel alone;
  walks_all_rounds_ms   `derive_walk_tables` and every walk round of the rung
                        (`decode3.walk_rounds`);
  no_recon_ms           `decode3.decode_planes_v3`: the walk rounds, the slot
                        assembly, the value join kernel, the records and the
                        placement, and a checksum of the planes fetched;
  full_ms               `decode3._decode_core_v3`, the reconstruction kernel
                        included, and a checksum of each image fetched.
As in the JAX script, recon_ms_est = full_ms - no_recon_ms and
assembly_ms_est = no_recon_ms - walks_all_rounds_ms (less word_blocks_ms,
which is null here); full_mbs is raw RGB8 MB (10**6 bytes) over full_ms.
Each time is the median of `reps` repeats after a warm-up, beside the
fastest and the slowest (`*_fastest`, `*_slowest`); on the card each timed
region ends in a synchronize.  One JSON line, closed by `reps`, `device` and
`card` (nvidia-smi's name and power limit).  The process exits non-zero
unless the full decode's `ok` is true for every image and its output equals
the images.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from nicetpu_torch.bench import card_line, make_image, prepare, require, stage_ms, timed

BATCH = 8
SIDE = 512
REPS = 3


def run(device="cuda", *, batch: int = BATCH, side: int = SIDE, reps: int = REPS,
        card: str | None = None) -> dict:
    """The line as a dict, printed and returned; raises on any unverified
    output."""
    from nicetpu_torch.hostref import oracle
    from nicetpu_torch.kernels import decode3
    from nicetpu_torch.kernels.geometry import Geometry

    dev = prepare(device)
    card = card if card is not None else card_line()
    imgs = [make_image(side, side, s) for s in range(batch)]
    blobs = [oracle.encode_native(im) for im in imgs]
    mb = sum(im.nbytes for im in imgs) / 1e6
    cfg = decode3.LADDER[0]
    kw = dict(geom=Geometry.uniform(side, side * side, batch, dev), chunk_bits=cfg.chunk_bits,
              steps=decode3._steps(cfg.chunk_bits, cfg.steps_div), rounds=cfg.rounds)
    secs: dict = {}

    def prep():
        return decode3.prepare_batch_args(blobs, device=dev)[0]

    prep()  # warm-up
    outs, secs["prep_host"] = timed(prep, reps, dev)
    args = outs[-1]
    words, wbits, af, present, ib, pfx, sym_tbl = args
    aff, dD, inc = decode3.derive_walk_tables(af, present, ib)
    nch = (words.shape[1] - decode3._wrows(cfg.chunk_bits)) // (cfg.chunk_bits // 32)
    entries = (torch.arange(nch, dtype=torch.int32, device=dev) * cfg.chunk_bits).expand(batch, nch)
    entries = entries.contiguous()
    wbits32 = wbits.to(torch.int32).contiguous()

    def walk1():
        return decode3.walk(words, entries, aff, dD, inc, pfx, wbits32,
                            chunk_bits=cfg.chunk_bits, steps=kw["steps"])[4]

    def walks():
        t = decode3.derive_walk_tables(af, present, ib)
        return decode3.walk_rounds(words, wbits, *t, pfx, chunk_bits=cfg.chunk_bits,
                                   steps=kw["steps"], rounds=cfg.rounds)[4:]

    def no_recon():
        form, delta, refoff, gates = decode3.decode_planes_v3(*args, **kw)
        return (form.sum(dtype=torch.int64) + delta.sum(dtype=torch.int64)).item(), gates.cpu().numpy()

    def full():
        out, ok, _ = decode3._decode_core_v3(*args, **kw)
        return out.sum(dim=(1, 2), dtype=torch.int64).cpu().numpy(), ok.cpu().numpy()

    for name, fn in (("walk1", walk1), ("walks_all_rounds", walks), ("no_recon", no_recon),
                     ("full", full)):
        fn()  # warm-up
        outs, secs[name] = timed(fn, reps, dev)

    want = [int(im.astype(np.int64).sum()) for im in imgs]
    for sums, ok in outs:
        require(bool(ok.all()), f"the full decode's ok is not all true: {ok.tolist()}")
        require([int(s) for s in sums] == want, "a decoded checksum differs from its image's")
    out, ok, _ = decode3._decode_core_v3(*args, **kw)
    out = out.cpu().numpy()
    require(bool(ok.all().item()) and all(
        np.array_equal(out[b].reshape(3, side, side).transpose(1, 2, 0), im) for b, im in enumerate(imgs)),
        "the full decode's output differs from the images")

    med = {k: statistics.median(v) for k, v in secs.items()}
    # the core's arguments, its geometry as the one shape it holds
    args_line = {"n_pixels": side * side, "width": side, **{k: v for k, v in kw.items() if k != "geom"}}
    line: dict = {"B": batch, "raw_mb": mb, "kw": args_line, "nch": nch}
    for k, v in secs.items():
        line.update(stage_ms(k, v))
    line["word_blocks_ms"] = None
    line["recon_ms_est"] = (med["full"] - med["no_recon"]) * 1e3
    line["assembly_ms_est"] = (med["no_recon"] - med["walks_all_rounds"]) * 1e3
    line["full_mbs"] = mb / med["full"]
    line.update(side=side, reps=reps, device=str(dev), card=card)
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--side", type=int, default=SIDE)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the bench runs on the card", file=sys.stderr)
        return 1
    run(args.device, batch=args.batch, side=args.side, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
