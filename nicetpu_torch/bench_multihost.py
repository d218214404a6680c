"""The sharded encode at 1, 2 and 4 ranks on one host (counterpart of
`bench_multihost.py`).

    python3 -m nicetpu_torch.bench_multihost [--ranks 1 2 4] [--height H] [--width W] [--reps R] [--device cuda|cpu]

The same raster, the JAX script's `make_image` (1024x512 by default, seed
5, a flat band of 50 rows at H/3), goes through
`dist.multihost.encode_multihost` on n ranks spawned by `dist.launch.run`,
for each n: one warm-up encode, then `reps` timed encodes (a barrier
before each), rank 0's fastest kept, as the JAX script keeps its best.
Every rank count does the same total work, so `efficiency_vs_1proc` (MB/s
over the 1-rank MB/s) says what the collective layout (halo ppermute,
summed histogram, all-gather of the run fix, ordered gather to rank 0)
costs as the ranks grow.  On the card every rank runs on cuda:0 over
gloo: NCCL refuses two ranks on one GPU.  The ranks time-slice the one
card and their collectives go through host memory, not NVLink or NCCL, so
the figure says nothing of scaling across cards; `note` says so on every
line.  `--device cpu` runs the kernels' plain versions on gloo.

One JSON line a rank count: `processes`, `devices_per_proc` (1: each rank
drives one device), `mb_s` (raw RGB8 MB, 10**6 bytes,
over rank 0's fastest seconds), `efficiency_vs_1proc` (null without a
1-rank run), `bytes`, `secs`, `reps`, `height`, `width`, `device`,
`launches` (rank 0's kernel launches over its encodes), `card` and `note`.
The process exits non-zero unless rank 0's bytes equal
`hostref.encode_native`'s and no rank fell back to the host encoder.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from nicetpu_torch.bench import card_line, require

H, W = 1024, 512
REPS = 3
RANKS = (1, 2, 4)
TIMEOUT = 600.0  # seconds a rank count's spawned ranks may take in all


def make_image(h: int = H, w: int = W) -> np.ndarray:
    """The JAX script's raster (a copy of `bench_multihost.make_image`, its
    H and W as arguments): flat levels plus 0..3 noise, seed 5, and a flat
    band of 50 rows at h/3."""
    rng = np.random.default_rng(5)
    base = (rng.integers(0, 6, (h, w, 1)) * 40).astype(np.int32)
    img = np.clip(base + rng.integers(0, 4, (h, w, 3)), 0, 255).astype("uint8")
    img[h // 3 : h // 3 + 50] = img[h // 3, 0]
    return img


def _rank(comm, device: str, h: int, w: int, reps: int) -> dict:
    """One rank: a warm-up encode, then `reps` timed ones; rank 0 returns
    the bytes, its seconds and its launches."""
    import torch.distributed as dist

    from nicetpu_torch.dist.multihost import encode_multihost
    from nicetpu_torch.kernels import cuda_ops

    img = make_image(h, w)
    stats: dict = {}
    cuda_ops.reset_launches()
    data = encode_multihost(img, device=device, stats=stats)
    secs = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        data = encode_multihost(img, device=device, stats=stats)
        secs.append(time.perf_counter() - t0)
    return {"data": data, "secs": secs, "overflow_fallbacks": stats["overflow_fallbacks"],
            "launches": dict(cuda_ops.LAUNCHES)}


def run(device="cuda", *, ranks=RANKS, height: int = H, width: int = W, reps: int = REPS,
        card: str | None = None) -> list[dict]:
    """Every rank count's line, each printed as it comes and returned;
    raises on any unverified output."""
    from nicetpu_torch.bench import prepare
    from nicetpu_torch.dist import launch
    from nicetpu_torch.hostref import oracle

    prepare(device)  # kernels built once, before any rank loads them
    card = card if card is not None else card_line()
    img = make_image(height, width)
    ref = oracle.encode_native(img)
    mb = img.nbytes / 1e6
    base = None
    lines = []
    for n in ranks:
        res = launch.run(_rank, n, backend="gloo", device=device,
                         args=(device, height, width, reps), timeout=TIMEOUT)
        require(res[0]["data"] == ref, f"{n} ranks: rank 0's bytes differ from hostref.encode_native")
        require(all(r["overflow_fallbacks"] == 0 for r in res),
                f"{n} ranks: a rank fell back to the host encoder")
        best = min(res[0]["secs"])
        mbs = mb / best
        if n == 1:
            base = mbs
        line = {
            "processes": n, "devices_per_proc": 1, "mb_s": mbs,
            "efficiency_vs_1proc": None if base is None else mbs / base,
            "bytes": len(res[0]["data"]), "secs": best, "reps": reps, "height": height,
            "width": width, "device": device, "launches": res[0]["launches"], "card": card,
            "note": (f"same total work at every count; {n} gloo rank(s) on one "
                     f"{'card (cuda:0), time-sliced' if device == 'cuda' else 'host CPU'}; "
                     "collectives through host memory, not NVLink or NCCL; "
                     "says nothing of scaling across cards"),
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=list(RANKS))
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the bench runs on the card", file=sys.stderr)
        return 1
    run(args.device, ranks=args.ranks, height=args.height, width=args.width, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
