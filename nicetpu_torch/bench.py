"""The port's headline bench: one JSON line (counterpart of `bench.py`).

    python3 -m nicetpu_torch.bench [--reps R] [--device cuda|cpu]

`value` is the round trip MB/s (raw RGB8 megabytes, 10**6 bytes, over
host-clock seconds) of 64 `make_image` 512x512 images, as 8 batches of 8
uploaded once (untimed), through `pipeline.roundtrip_hybrid` at its defaults:
one device worker and one host worker.  Every blob must equal
`hostref.encode_native`'s and every array its image, and each repeat
decodes one device-produced blob with `hostref.decode_native`.  Beside it:

  gpu_share            batches the device worker verified, over 8
  baseline_native_mbs  the serial native round trip on this host, this run
  device_only          the fused encode of 4 resident batches, enqueued back
                       to back, then one fetch of their small arrays
  device_roundtrip     `decode3.roundtrip_verify_fused` over 4 resident
                       batches; every image verified on the device
  decode_device_e2e    `decode3.decode_batch_v3` from bytes, 8 blobs
  decode_device        `decode3._decode_core_v3` on prepared arguments, with
                       a per-image checksum fetched and held to the images'
  ratio                raw bytes over `.nice` bytes

Each timing is the median of `reps` repeats, with the fastest and the
slowest beside it (`*_fastest`, `*_slowest`), all in the same call: host
speed varies 30 % or more between calls.  `counts` holds each section's
retries, fallbacks and overflow fallbacks; `degraded` is true if any of them
counted a fallback, and `value` is null when the device verified no batch
in a repeat: a hybrid figure from a run in which the device did no work is
never reported.  Any unverified output raises and the process exits
non-zero.  The kernels are built before anything is timed.  `card` is
nvidia-smi's name and power limit of the card.

`hybrid_sweep` times the hybrid section alone at each count of GPU workers
(one host worker beside them), the counts taken in turn within each repeat;
`chip_smoke.py` calls it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_IMAGES = 64
BATCH = 8
SIDE = 512
DEVICE_BATCHES = 4  # resident batches of the device-only sections
REPS = 3
COUNTS = ("retries", "fallbacks", "overflow_fallbacks")


def make_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """The bench's test image (a copy of `bench.make_image`): smooth
    gradients plus +-3 noise, seeded."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(xx / 37.0) + 50 * np.cos(yy / 23.0)).astype(np.int32)
    img = np.stack(
        [base, base + np.sin(xx / 11.0) * 20, base - np.cos(yy / 7.0) * 15], axis=-1
    )
    return np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards, one line each."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return res.stdout.strip() or res.stderr.strip()


def prepare(device) -> torch.device:
    """The bench's device; on the card, the kernels built and loaded and
    the host codec loaded, so that no timed region holds a build.  Raises
    where CUDA is asked for and absent."""
    from nicetpu_torch.config import resolve_device
    from nicetpu_torch.hostref import oracle

    dev = resolve_device(device)
    if dev.type == "cuda":
        from nicetpu_torch.kernels import build

        build.load()
    oracle.get_lib()
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, reps: int, dev: torch.device) -> tuple[list, list[float]]:
    """fn() `reps` times, each call's device work inside its time; returns
    (results, seconds)."""
    outs, secs = [], []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        outs.append(fn())
        sync(dev)
        secs.append(time.perf_counter() - t0)
    return outs, secs


def rates(name: str, mb: float, secs: list[float]) -> dict:
    """MB/s at the median time, with the fastest and the slowest repeat."""
    return {name: mb / statistics.median(secs), f"{name}_fastest": mb / min(secs),
            f"{name}_slowest": mb / max(secs)}


def stage_ms(name: str, secs: list[float]) -> dict:
    """A stage's milliseconds at the median repeat, with the fastest and
    the slowest (`<name>_ms`, `_ms_fastest`, `_ms_slowest`)."""
    return {f"{name}_ms": statistics.median(secs) * 1e3, f"{name}_ms_fastest": min(secs) * 1e3,
            f"{name}_ms_slowest": max(secs) * 1e3}


def tally(counts: dict, section: str, stats: dict) -> None:
    into = counts.setdefault(section, dict.fromkeys(COUNTS, 0))
    for k in COUNTS:
        into[k] += int(stats.get(k, 0))


def degraded(counts: dict) -> bool:
    """True if any section counted a host fallback (Queue 3d)."""
    return any(c["fallbacks"] or c["overflow_fallbacks"] for c in counts.values())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _hybrid_once(batches, host_batches, imgs, refs, rep, dev, counts, section="hybrid", **workers):
    """One timed, verified run of roundtrip_hybrid (`workers`: its thread
    counts, else its defaults); returns (seconds, gpu_batches)."""
    from nicetpu_torch import pipeline
    from nicetpu_torch.hostref import oracle

    sync(dev)
    t0 = time.perf_counter()
    results, stats = pipeline.roundtrip_hybrid(batches, **workers)
    sync(dev)
    seconds = time.perf_counter() - t0
    blobs = [d for out in results for d, _ in out]
    require(blobs == refs, "a hybrid blob differs from hostref.encode_native")
    require(all(np.array_equal(a, im) for out, hb in zip(results, host_batches)
                for (_, a), im in zip(out, hb)), "a hybrid array differs from its image")
    # device workers take batches from the front: the first gpu_batches
    # batches are the device's; one of their blobs is decoded by the host
    n_dev = stats["gpu_batches"] * len(host_batches[0])
    if n_dev:
        k = rep % n_dev
        require(np.array_equal(oracle.decode_native(blobs[k]), imgs[k]),
                f"device blob {k} does not decode to its image on the host")
    tally(counts, section, stats)
    return seconds, stats["gpu_batches"]


def _hybrid(batches, host_batches, imgs, refs, reps, dev, counts):
    """The headline section: `reps` timed runs of roundtrip_hybrid."""
    mb = sum(im.nbytes for im in imgs) / 1e6
    secs, gpu_batches = [], []
    for rep in range(reps):
        seconds, n_gpu = _hybrid_once(batches, host_batches, imgs, refs, rep, dev, counts)
        secs.append(seconds)
        gpu_batches.append(n_gpu)
    out = rates("value", mb, secs)
    if min(gpu_batches) == 0:
        out = dict.fromkeys(out)  # the device did no work in a repeat: no headline
    out["gpu_batches"] = gpu_batches
    out["gpu_share"] = statistics.median(gpu_batches) / len(batches)
    return out


def device_only(batches, refs, reps, dev, counts) -> list[float]:
    """The fused encode of the resident batches, enqueued back to back, then
    one fetch of each small array; lengths and payload sizes held to the
    native encoder's streams, where the encode did not overflow (counted).
    Returns the seconds of each repeat."""
    from nicetpu_torch import pipeline
    from nicetpu_torch.format import constants as C
    from nicetpu_torch.format import headers
    from nicetpu_torch.kernels import decode3
    from nicetpu_torch.kernels.encode2 import encode_fused
    from nicetpu_torch.kernels.geometry import Geometry

    H, W, _ = batches[0][0][0].shape
    cap = pipeline.w_cap(H * W)
    geoms = [Geometry.uniform(W, H * W, flat.shape[0], flat.device) for _, flat in batches]

    def enc_round():
        smalls = [encode_fused(flat, geom=g, ndigits_cap=3, w_cap=cap)[1] for (_, flat), g in zip(batches, geoms)]
        return [s.cpu().numpy() for s in smalls]

    outs, secs = timed(enc_round, reps, dev)
    k = 0
    for small in outs[-1]:
        for row in small:
            if row[859]:  # overflowed: the native encoder's stream, counted below
                k += 1
                continue
            lengths = headers.parse_stream_headers(refs[k][C.FILE_HEADER_BYTES :])
            require(np.array_equal(row[:858], lengths), f"device encode {k}: code lengths differ")
            # the stream holds the payload's whole bytes and one more
            require(int(row[858]) // 8 + 1 == decode3.payload_bits(refs[k]) // 8,
                    f"device encode {k}: payload size differs")
            k += 1
    ovf = sum(int(s[:, 859].sum()) for s in outs[-1])
    tally(counts, "device_only", {"overflow_fallbacks": ovf})
    return secs


def _device_roundtrip(batches, reps, dev, counts):
    from nicetpu_torch.kernels import decode3
    from nicetpu_torch.kernels.geometry import Geometry

    H, W, _ = batches[0][0][0].shape
    geoms = [Geometry.uniform(W, H * W, flat.shape[0], flat.device) for _, flat in batches]

    def rt_round():
        stats = []
        for (_, flat), geom in zip(batches, geoms):
            st: dict = {}
            _, small, verified = decode3.roundtrip_verify_fused(flat, geom=geom, stats=st)
            st["overflow_fallbacks"] = int(small[:, 859].sum())
            require(bool(verified.all()), f"device round trip not verified: {verified.tolist()}")
            stats.append(st)
        return stats

    outs, secs = timed(rt_round, reps, dev)
    for st in (s for rep in outs for s in rep):
        tally(counts, "device_roundtrip", st)
    return secs


def _decode(blobs, imgs, reps, dev, counts):
    """decode_batch_v3 from bytes, then the decode core on prepared
    arguments with a per-image checksum."""
    from nicetpu_torch.kernels import decode3
    from nicetpu_torch.kernels.geometry import Geometry

    mb = sum(im.nbytes for im in imgs) / 1e6
    stats_e2e: list = []

    def e2e():
        st: dict = {}
        out = decode3.decode_batch_v3(blobs, device=dev, stats=st)
        stats_e2e.append(st)
        return out

    outs, secs = timed(e2e, reps, dev)
    for out in outs:
        require(all(np.array_equal(o, im) for o, im in zip(out, imgs)), "decode_batch_v3 differs")
    for st in stats_e2e:
        tally(counts, "decode_device_e2e", st)
    res = rates("decode_device_e2e", mb, secs)

    args, (H, W) = decode3.prepare_batch_args(blobs, device=dev)
    cfg = decode3.LADDER[0]
    kw = dict(geom=Geometry.uniform(W, H * W, len(blobs), dev), chunk_bits=cfg.chunk_bits,
              steps=decode3._steps(cfg.chunk_bits, cfg.steps_div), rounds=cfg.rounds)

    def core():
        out, ok, _ = decode3._decode_core_v3(*args, **kw)
        return out.sum(dim=(1, 2), dtype=torch.int64).cpu().numpy(), ok.cpu().numpy()

    outs, secs = timed(core, reps, dev)
    want = [int(im.astype(np.int64).sum()) for im in imgs]
    for sums, ok in outs:
        require(all(int(s) == w for s, w, k in zip(sums, want, ok) if k),
                "a decoded checksum differs from its image's")
        tally(counts, "decode_device", {"fallbacks": int((~ok).sum())})
    res.update(rates("decode_device", mb, secs))
    return res


def run(device="cuda", *, n_images: int = N_IMAGES, batch: int = BATCH, side: int = SIDE,
        reps: int = REPS, device_batches: int = DEVICE_BATCHES, card: str | None = None) -> dict:
    """The bench's line as a dict (see the module docstring); raises on any
    unverified output."""
    from nicetpu_torch import pipeline
    from nicetpu_torch.hostref import oracle

    dev = prepare(device)
    imgs = [make_image(side, side, s) for s in range(n_images)]
    refs = [oracle.encode_native(im) for im in imgs]
    mb = sum(im.nbytes for im in imgs) / 1e6
    host_batches = [imgs[i : i + batch] for i in range(0, n_images, batch)]
    batches = [(hb, pipeline.upload_batch(hb, dev)) for hb in host_batches]
    sync(dev)

    # the serial native round trip of the first batch on this host
    def native():
        return [oracle.decode_native(oracle.encode_native(im)) for im in host_batches[0]]

    outs, secs = timed(native, reps, dev)
    require(all(np.array_equal(o, im) for o, im in zip(outs[-1], host_batches[0])),
            "the native round trip differs")
    base = rates("baseline_native_mbs", sum(im.nbytes for im in host_batches[0]) / 1e6, secs)

    counts: dict = {}
    # warm-up: one hybrid pass, untimed and uncounted, then the timed repeats
    pipeline.roundtrip_hybrid(batches)
    line = {"metric": f"encode+decode MB/s ({n_images} {side}x{side} RGB8 bit-exact round trips, "
                      f"roundtrip_hybrid 1 GPU + 1 host worker)", "unit": "MB/s"}
    line.update(_hybrid(batches, host_batches, imgs, refs, reps, dev, counts))
    line.update(base)
    line["vs_baseline"] = (None if line["value"] is None
                           else line["value"] / line["baseline_native_mbs"])
    resident = batches[:device_batches]
    mb_res = sum(im.nbytes for hb, _ in resident for im in hb) / 1e6
    line.update(rates("device_only", mb_res, device_only(resident, refs, reps, dev, counts)))
    line.update(rates("device_roundtrip", mb_res, _device_roundtrip(resident, reps, dev, counts)))
    line.update(_decode(refs[:batch], imgs[:batch], reps, dev, counts))
    line["ratio"] = mb * 1e6 / sum(len(b) for b in refs)
    line["counts"] = counts
    line["degraded"] = degraded(counts)
    line.update(reps=reps, images=n_images, batch=batch, side=side, device=str(dev),
                card=card if card is not None else card_line())
    return line


def hybrid_sweep(device="cuda", *, gpu_threads=(1, 2, 3), reps: int = REPS, n_images: int = N_IMAGES,
                 batch: int = BATCH, side: int = SIDE, card: str | None = None) -> dict:
    """The headline's roundtrip_hybrid at each count of device workers, one
    host worker beside them, over the same uploaded batches; within each
    repeat the counts take their turn in order.  Returns one line: MB/s
    (median, fastest, slowest) and gpu_batches by count, the counts of
    fallbacks, `degraded` and `card`.  Raises on any unverified output."""
    from nicetpu_torch import pipeline
    from nicetpu_torch.hostref import oracle

    dev = prepare(device)
    imgs = [make_image(side, side, s) for s in range(n_images)]
    refs = [oracle.encode_native(im) for im in imgs]
    mb = sum(im.nbytes for im in imgs) / 1e6
    host_batches = [imgs[i : i + batch] for i in range(0, n_images, batch)]
    batches = [(hb, pipeline.upload_batch(hb, dev)) for hb in host_batches]
    pipeline.roundtrip_hybrid(batches)  # warm-up, untimed and uncounted
    secs: dict = {g: [] for g in gpu_threads}
    n_gpu: dict = {g: [] for g in gpu_threads}
    counts: dict = {}
    for rep in range(reps):
        for g in gpu_threads:
            seconds, gb = _hybrid_once(batches, host_batches, imgs, refs, rep, dev, counts,
                                       section=f"hybrid_{g}", gpu_threads=g, cpu_threads=1)
            secs[g].append(seconds)
            n_gpu[g].append(gb)
    by = {str(g): {**rates("value", mb, secs[g]), "gpu_batches": n_gpu[g]} for g in gpu_threads}
    return {"metric": f"encode+decode MB/s ({n_images} {side}x{side} RGB8 bit-exact round trips, "
                      f"roundtrip_hybrid by GPU workers, 1 host worker)", "unit": "MB/s",
            "by_gpu_threads": by, "counts": counts, "degraded": degraded(counts), "reps": reps,
            "device": str(dev), "card": card if card is not None else card_line()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the bench runs on the card", file=sys.stderr)
        return 1
    print(json.dumps(run(args.device, reps=args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
