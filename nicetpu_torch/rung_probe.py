"""Which walk rung verifies a `make_img` raster, on one device and across
ranks, with the peak device memory: one JSON line a rung and path.

    python3 -m nicetpu_torch.rung_probe --height 8192 [--width 16384] [--ranks 4]

On one device, each rung of `decode3.LADDER` runs the decode core on the
raster's stream (`MAX_DEVICE_BITS` or more: skipped) and reports the four
gates, equality with the raster and the peak device memory; a CUDA
out-of-memory error is reported as the rung's result.  With --ranks n,
the raster is also encoded and decoded by `encode_sharded` and
`decode_sharded` on each rung over n gloo ranks on the one card.  A probe
for the open questions of PERF.md, not a bench: it exits 0 whatever the
gates say, and non-zero only where CUDA is asked for and absent.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from nicetpu_torch.bench import prepare, sync
from nicetpu_torch.bench_all import CONFIG5_SEED, make_img, peak_gib, peak_reset

GATES = ("consistency", "crossing", "coverage", "backref")


def single_device(dev, img: np.ndarray, data: bytes) -> list[dict]:
    """Each rung's gates, equality and peak memory on one device."""
    from nicetpu_torch.kernels import decode3
    from nicetpu_torch.kernels.geometry import Geometry

    bits = decode3.payload_bits(data)
    if bits >= decode3.MAX_DEVICE_BITS:
        return [{"path": "single device", "payload_bits": bits, "skipped": "past MAX_DEVICE_BITS"}]
    args, (H, W) = decode3.prepare_batch_args([data], device=dev)
    geom = Geometry.uniform(W, H * W, 1, dev)
    out = []
    for rung, cfg in enumerate(decode3.LADDER):
        res = {"path": "single device", "rung": rung, "cfg": tuple(cfg), "payload_bits": bits}
        peak_reset(dev)
        t0 = time.perf_counter()
        try:
            planar, ok, gates = decode3._decode_core_v3(
                *args, geom=geom, chunk_bits=cfg.chunk_bits,
                steps=decode3._steps(cfg.chunk_bits, cfg.steps_div), rounds=cfg.rounds)
            sync(dev)
            res["gates"] = dict(zip(GATES, (bool(g) for g in gates[0])))
            res["equal"] = bool(np.array_equal(planar[0].cpu().numpy().T.reshape(img.shape), img))
            del planar, ok, gates
        except torch.OutOfMemoryError as e:
            res["out_of_memory"] = str(e).split(".")[0]
        res.update(seconds=time.perf_counter() - t0, peak_device_gib=peak_gib(dev))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out.append(res)
    return out


def _sharded_rank(comm, height: int, width: int, device: str, rung: int) -> dict:
    from nicetpu_torch.dist.sharded import encode_sharded
    from nicetpu_torch.dist.sharded_decode import decode_sharded
    from nicetpu_torch.kernels import decode3

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    img = make_img(height, width, CONFIG5_SEED)
    data = encode_sharded(img, device=device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    peak_reset(dev)
    stats: dict = {}
    got = decode_sharded(data, device=device, cfg=decode3.LADDER[rung], stats=stats)
    return {"gates": stats.get("gates"), "fallbacks": stats["fallbacks"],
            "equal": bool(np.array_equal(got, img)), "decode_peak_device_gib": peak_gib(dev)}


def sharded(dev, height: int, width: int, ranks: int) -> list[dict]:
    """Each rung through decode_sharded over `ranks` gloo ranks."""
    from nicetpu_torch.dist import launch
    from nicetpu_torch.kernels import decode3

    out = []
    for rung, cfg in enumerate(decode3.LADDER):
        t0 = time.perf_counter()
        res = launch.run(_sharded_rank, ranks, backend="gloo", device=dev.type,
                         args=(height, width, dev.type, rung), timeout=900)
        out.append({"path": f"{ranks} gloo ranks", "rung": rung, "cfg": tuple(cfg), **res[0],
                    "decode_peak_device_gib": [r["decode_peak_device_gib"] for r in res],
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, default=None, help="default: the height")
    ap.add_argument("--ranks", type=int, default=0, help="also decode across this many gloo ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the probe runs on the card", file=sys.stderr)
        return 1
    from nicetpu_torch.hostref import oracle

    dev = prepare(args.device)
    width = args.width or args.height
    img = make_img(args.height, width, CONFIG5_SEED)
    lines = single_device(dev, img, oracle.encode_native(img))
    del img
    if args.ranks:
        lines += sharded(dev, args.height, width, args.ranks)
    for ln in lines:
        print(json.dumps({"raster": f"make_img({args.height}, {width}, {CONFIG5_SEED})", **ln}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
