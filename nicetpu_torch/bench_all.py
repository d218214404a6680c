"""The port's extended bench: the five BASELINE configs, one JSON line a
measurement (counterpart of `bench_all.py`).

    python3 -m nicetpu_torch.bench_all [--config N] [--side S] [--reps R] [--device cuda|cpu]

  1. a 512x512 RGB8 image: `api.encode`, then `api.decode`, on the card;
  2. 24 real-photo patches of 768x512 (the Kodak-24 size, `real_patches`
     of the corpus in `nicetpu_torch/data/realcorpus/`): `api.encode_batch`,
     `api.decode_batch`, the device-compute encode of the resident batches
     and the device-compute decode through the retry ladder;
  3. a 4096x4096 RGBA encode (alpha dropped, as the reference encoder
     does), and the 4096x4096 round trip, each with its peak device memory
     (synthetic `make_img`, `config3_raster`); then the 2048x2048 real photo
     (`soccer0`, `config3_real`): `decode3.decode_batch_v3` of its bytes
     and the device-compute decode through the retry ladder on resident
     arguments, each with its fallbacks, retries and gates;
  4. 100 photo patches of mixed sizes (sides 128..767, `texture_patches`:
     cut from the corpus's wood, marble and skin textures in turn, at
     seeded offsets), encoded and decoded with the `native` backend and on
     the card;
  5. one `make_img(14336, 14336, 5)` raster (a payload of about 2.4 G
     bits, past 2**31) through `encode_sharded` and `decode_sharded` on its
     default rung, the robust one (`decode3.LADDER[-1]`), over 4 ranks:
     NCCL, one rank a card, where there are 4 cards, else 4 gloo ranks
     time-sliced on the one card (no scaling).  BASELINE's 16384x16384 waits
     for four cards: its encode peaks at about 18.3 GiB a rank, too close
     to one card's 80 GB for four ranks, and the fast rung fails its gates
     on that raster (PERF.md).  --side sets another raster side; the line
     names the side it ran.

Every line is `{"config", "value", "unit", "note", ...}` with `value` the
MB/s (10**6 raw bytes a second) at the median of `reps` repeats,
`fastest`/`slowest` beside it, `verified`, the fallback counts, `degraded`
(true where any was counted) and, where the config asks for it,
`peak_device_gib` (`torch.cuda.max_memory_allocated`, reset before the
section).  Any inexact output raises and the process exits non-zero; the
counted host fallbacks, which real photos may cause, are reported, never
hidden.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from nicetpu_torch.bench import card_line, prepare, rates, require, sync, timed

REPS = 3
CONFIG5_SIDE = 14336  # the least side of 1024s whose payload passes 2**31 bits
CONFIG5_SEED = 5
CONFIG5_RANKS = 4
CONFIG5_WARM_SIDE = 512  # each rank warms on a raster this size first
CONFIG5_TIMEOUT = 900.0  # seconds the spawned ranks may take in all
KODAK = (24, 512, 768)  # images, height, width
MIXED = (100, 128, 768)  # images, smallest side, one past the largest
TEXTURES = ("wood", "marble", "skin")  # the corpus's 1024x1024 photographic textures
REAL_SIDE = 2048  # config 3's real photo: soccer0, whole
MAKE_IMG_ROWS = 256  # rows of `make_img` built at a time


def make_img(h: int, w: int, seed: int = 0, rgba: bool = False) -> np.ndarray:
    """`bench_all.make_img`'s image, built MAKE_IMG_ROWS rows at a time so
    that a 14336x14336 raster needs its own bytes and one block's
    temporaries, not float64 temporaries of the whole raster: the same
    values element by element, and the generator's stream is the same when
    it is drawn in blocks."""
    r = np.random.default_rng(seed)
    out = np.empty((h, w, 4 if rgba else 3), np.uint8)
    if rgba:
        out[..., 3] = 255
    xx = np.arange(w)[None, :]
    for y0 in range(0, h, MAKE_IMG_ROWS):
        yy = np.arange(y0, min(h, y0 + MAKE_IMG_ROWS))[:, None]
        base = (128 + 60 * np.sin(xx / (30 + seed)) + 50 * np.cos(yy / 23.0)).astype(np.int32)
        img = np.stack(
            [base, base + np.sin(xx / 11.0) * 20, base - np.cos(yy / 7.0) * 15], axis=-1
        )
        out[y0 : y0 + yy.shape[0], :, :3] = np.clip(img + r.integers(-3, 4, img.shape), 0, 255)
    return out


@functools.cache
def _corpus_images() -> tuple:
    from nicetpu_torch.realcorpus import load_corpus

    return tuple(im for _, im in load_corpus())


def real_patches(n: int, h: int, w: int) -> list[np.ndarray]:
    """n real-photo (h, w, 3) patches tiled out of the realcorpus images (a
    copy of `bench_all.real_patches`; the corpus is read once)."""
    corpus = list(_corpus_images())
    out: list[np.ndarray] = []
    while len(out) < n:
        added = 0
        for im in corpus:
            if len(out) >= n:
                break
            H, W = im.shape[:2]
            while H < h or W < w:
                # upsample small camera shots by pixel-doubling until the
                # patch fits (still photo statistics, unlike sinusoids)
                im = np.repeat(np.repeat(im, 2, axis=0), 2, axis=1)
                H, W = im.shape[:2]
            k = len(out)
            y0 = (k * 173) % max(1, H - h + 1)
            x0 = (k * 257) % max(1, W - w + 1)
            out.append(im[y0 : y0 + h, x0 : x0 + w].copy())  # the cached corpus stays unshared
            added += 1
        if not added:  # empty corpus: fail loudly instead of spinning
            raise RuntimeError("real_patches: corpus produced no usable image")
    return out


def texture_patches(sizes, seed: int) -> list[np.ndarray]:
    """(h, w, 3) patches of the corpus's photographic textures, one a size,
    from TEXTURES in turn, each at offsets drawn from `seed`; nothing is
    resampled, so every side is at most 1024."""
    from nicetpu_torch.realcorpus import NAMES

    textures = dict(zip(NAMES, _corpus_images()))
    rng = np.random.default_rng(seed)
    out = []
    for k, (h, w) in enumerate(sizes):
        im = textures[TEXTURES[k % len(TEXTURES)]]
        y0, x0 = int(rng.integers(0, im.shape[0] - h + 1)), int(rng.integers(0, im.shape[1] - w + 1))
        out.append(im[y0 : y0 + h, x0 : x0 + w].copy())
    return out


def peak_reset(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev: torch.device) -> float | None:
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def line(config: str, mb: float, secs: list[float], note: str, *, reps: int, card: str,
         fallbacks: int = 0, **extra) -> dict:
    r = rates("value", mb, secs)
    return {"config": config, "value": r["value"], "unit": "MB/s", "note": note,
            "fastest": r["value_fastest"], "slowest": r["value_slowest"], "verified": True,
            "fallbacks": fallbacks, **extra,
            "degraded": bool(fallbacks or extra.get("overflow_fallbacks")), "reps": reps, "card": card}


def _sum(stats: list[dict], key: str) -> int:
    return sum(int(s.get(key, 0)) for s in stats)


def config1(dev, *, side: int = 512, reps: int = REPS, card: str) -> list[dict]:
    """512x512 round trip: api.encode, then api.decode."""
    from nicetpu_torch import api
    from nicetpu_torch.hostref import oracle

    img = make_img(side, side)
    ref = oracle.encode_native(img)
    api.decode(api.encode(img, device=dev), device=dev)  # warm-up
    est, dst = [], []

    def rt():
        est.append({})
        dst.append({})
        data = api.encode_batch([img], device=dev, stats=est[-1])[0]
        return data, api.decode_batch([data], device=dev, stats=dst[-1])[0]

    outs, secs = timed(rt, reps, dev)
    require(all(d == ref for d, _ in outs), "config 1: bytes differ from hostref.encode_native")
    require(all(np.array_equal(o, img) for _, o in outs), "config 1: the decode differs")
    return [line(f"1: {side}x{side} RGB8 round trip (api.encode + api.decode, {dev.type})",
                 img.nbytes / 1e6, secs, "bytes equal hostref.encode_native, decode exact",
                 reps=reps, card=card, fallbacks=_sum(dst, "fallbacks"),
                 overflow_fallbacks=_sum(est, "overflow_fallbacks"))]


def _ladder_checksums(dev, blobs):
    """The device-compute decode of one batch through the retry ladder: the
    prepared arguments, then per rung the decode core with a per-image
    checksum; returns a call giving (ok (B,), sums (B,), retries, the gates
    of the last rung run)."""
    from nicetpu_torch.kernels import decode3
    from nicetpu_torch.kernels.geometry import Geometry

    args, (H, W) = decode3.prepare_batch_args(blobs, device=dev)
    geom = Geometry.uniform(W, H * W, len(blobs), dev)

    def call(cfg):
        out, ok, gates = decode3._decode_core_v3(
            *args, geom=geom, chunk_bits=cfg.chunk_bits,
            steps=decode3._steps(cfg.chunk_bits, cfg.steps_div), rounds=cfg.rounds)
        return (ok.cpu().numpy(), (out.sum(dim=(1, 2), dtype=torch.int64).cpu().numpy(),),
                gates.cpu().numpy())

    def run():
        st: dict = {}
        ok, (sums,) = decode3.run_ladder(call, len(blobs), stats=st)
        return ok, sums, st["retries"], st["gates"]

    return run


def _ladder_line(config: str, dev, blob_batches, imgs, reps: int, card: str) -> dict:
    """The device-compute decode of same-shape batches through the retry
    ladder, timed over all of them; the checksums of the images the device
    verified equal theirs."""
    runs = [_ladder_checksums(dev, b) for b in blob_batches]
    want = [int(im.astype(np.int64).sum()) for im in imgs]
    outs, secs = timed(lambda: [run() for run in runs], reps, dev)
    fallbacks = retries = 0
    for rep in outs:
        got = np.concatenate([sums for _, sums, _, _ in rep])
        ok = np.concatenate([o for o, _, _, _ in rep])
        require(all(int(g) == v for g, v, k in zip(got, want, ok) if k),
                f"config {config[0]}: a device checksum differs from its image's")
        fallbacks += int((~ok).sum())
        retries += sum(rt for _, _, rt, _ in rep)
    gates = [row for _, _, _, g in outs[-1] for row in g]
    return line(config, sum(im.nbytes for im in imgs) / 1e6, secs,
                "checksums equal the images' where the device verified them", reps=reps, card=card,
                fallbacks=fallbacks, retries=retries,
                gates=[[bool(x) for x in row] for row in gates])


def config2(dev, *, n: int = KODAK[0], h: int = KODAK[1], w: int = KODAK[2], reps: int = REPS,
            card: str) -> list[dict]:
    """The Kodak-24 size on real-photo patches: batch encode, batch decode,
    and their device compute alone."""
    from nicetpu_torch import api, pipeline
    from nicetpu_torch.bench import device_only
    from nicetpu_torch.hostref import oracle

    imgs = real_patches(n, h, w)
    refs = oracle.encode_batch_native(imgs)
    mb = sum(im.nbytes for im in imgs) / 1e6
    label = f"{n} x {w}x{h} RGB8 (real photo patches, Kodak-24 size)"
    api.decode_batch(api.encode_batch(imgs[:8], device=dev), device=dev)  # warm-up
    est, dst = [], []

    def enc():
        est.append({})
        return api.encode_batch(imgs, device=dev, stats=est[-1])

    def dec():
        dst.append({})
        return api.decode_batch(refs, device=dev, stats=dst[-1])

    outs, secs_e = timed(enc, reps, dev)
    require(all(o == refs for o in outs), "config 2: encode_batch differs from hostref")
    outs, secs_d = timed(dec, reps, dev)
    require(all(np.array_equal(a, im) for o in outs for a, im in zip(o, imgs)),
            "config 2: decode_batch differs")
    lines = [
        line(f"2: {label}, api.encode_batch", mb, secs_e, "bytes equal hostref.encode_native",
             reps=reps, card=card, overflow_fallbacks=_sum(est, "overflow_fallbacks"),
             ratio=mb * 1e6 / sum(len(r) for r in refs)),
        line(f"2: {label}, api.decode_batch", mb, secs_d, "arrays exact", reps=reps, card=card,
             fallbacks=_sum(dst, "fallbacks"), retries=_sum(dst, "retries")),
    ]

    host_batches = [imgs[i : i + 8] for i in range(0, n, 8)]
    batches = [(hb, pipeline.upload_batch(hb, dev)) for hb in host_batches]
    counts: dict = {}
    secs = device_only(batches, refs, reps, dev, counts)
    lines.append(line(f"2: {label}, device-compute encode (resident batches, small arrays fetched)",
                      mb, secs, "code lengths and payload sizes equal hostref's", reps=reps,
                      card=card, overflow_fallbacks=counts["device_only"]["overflow_fallbacks"]))
    lines.append(_ladder_line(f"2: {label}, device-compute decode (retry ladder, checksums fetched)",
                              dev, [refs[i : i + 8] for i in range(0, n, 8)], imgs, reps, card))
    return lines


def config3_raster(dev, *, side: int = 4096, reps: int = 2, card: str) -> list[dict]:
    """A 4096x4096 RGBA encode (alpha dropped) and the RGB round trip."""
    from nicetpu_torch import api
    from nicetpu_torch.hostref import oracle

    big = make_img(side, side, 3, rgba=True)
    rgb = np.ascontiguousarray(big[:, :, :3])
    ref = oracle.encode_native(rgb)
    mb = rgb.nbytes / 1e6
    api.encode(big, device=dev)  # warm-up
    est = []

    def enc():
        est.append({})
        return api.encode_batch([big], device=dev, stats=est[-1])[0]

    peak_reset(dev)
    outs, secs = timed(enc, reps, dev)
    enc_peak = peak_gib(dev)
    require(all(o == ref for o in outs), "config 3: the RGBA encode differs from hostref's RGB stream")
    rst = []

    def rt():
        rst.append({})
        return api.roundtrip_batch([rgb], device=dev, stats=rst[-1])

    peak_reset(dev)
    outs, secs_rt = timed(rt, reps, dev)
    rt_peak = peak_gib(dev)
    require(all(d[0] == ref for d, _ in outs), "config 3: round-trip bytes differ from hostref")
    verified = all(bool(v[0]) for _, v in outs)
    require(verified or _sum(rst, "fallbacks") + _sum(rst, "overflow_fallbacks") > 0,
            "config 3: an image neither verified on the device nor counted")
    return [
        line(f"3: {side}x{side} RGBA encode (alpha dropped, {dev.type})", mb, secs,
             "bytes equal hostref.encode_native of the RGB image", reps=reps, card=card,
             overflow_fallbacks=_sum(est, "overflow_fallbacks"), peak_device_gib=enc_peak),
        line(f"3: {side}x{side} RGB8 round trip (api.roundtrip_batch, {dev.type})", mb, secs_rt,
             "bytes equal hostref.encode_native; decoded and compared on the device",
             reps=reps, card=card, fallbacks=_sum(rst, "fallbacks"),
             overflow_fallbacks=_sum(rst, "overflow_fallbacks"), retries=_sum(rst, "retries"),
             verified_on_device=verified, peak_device_gib=rt_peak),
    ]


def config3_real(dev, *, side: int = REAL_SIDE, reps: int = 2, card: str) -> list[dict]:
    """The 2048x2048 real photo (soccer0, centre-cropped to side): its
    bytes through `decode3.decode_batch_v3`, then the decode core through
    the retry ladder on resident arguments."""
    from nicetpu_torch.hostref import oracle
    from nicetpu_torch.kernels import decode3
    from nicetpu_torch.realcorpus import load_corpus

    img = dict(load_corpus(max_dim=side))["soccer0"]
    blob = oracle.encode_native(img)
    label = f"{img.shape[0]}x{img.shape[1]} real photo (soccer0)"
    decode3.decode_batch_v3([blob], device=dev)  # warm-up
    dst = []

    def dec():
        dst.append({})
        return decode3.decode_batch_v3([blob], device=dev, stats=dst[-1])[0]

    peak_reset(dev)
    outs, secs = timed(dec, reps, dev)
    peak = peak_gib(dev)
    require(all(np.array_equal(o, img) for o in outs), "config 3: the real photo's decode differs")
    return [
        line(f"3: {label}, decode3.decode_batch_v3 ({dev.type})", img.nbytes / 1e6, secs,
             "array exact", reps=reps, card=card, fallbacks=_sum(dst, "fallbacks"),
             retries=_sum(dst, "retries"), gates=dst[-1].get("gates"), peak_device_gib=peak,
             ratio=img.nbytes / len(blob)),
        _ladder_line(f"3: {label}, device-compute decode (retry ladder, checksum fetched)", dev,
                     [[blob]], [img], reps, card),
    ]


def config3(dev, *, side: int = 4096, real_side: int = REAL_SIDE, reps: int = 2,
            card: str) -> list[dict]:
    return (config3_raster(dev, side=side, reps=reps, card=card)
            + config3_real(dev, side=real_side, reps=reps, card=card))


def mixed_sizes(n: int = MIXED[0], lo: int = MIXED[1], hi: int = MIXED[2]) -> list[tuple[int, int]]:
    """Config 4's n (h, w) sizes, each side uniform on lo..hi - 1, drawn from
    default_rng(9) (the benchmark's mixed100 shapes)."""
    rng = np.random.default_rng(9)
    return [(int(rng.integers(lo, hi)), int(rng.integers(lo, hi))) for _ in range(n)]


def config4(dev, *, n: int = MIXED[0], lo: int = MIXED[1], hi: int = MIXED[2], reps: int = 1,
            card: str) -> list[dict]:
    """100 photo patches of mixed sizes (`texture_patches`): the host
    codec's encode and decode, then one `api.roundtrip_batch` of the whole
    set on the card, which shares device batches of up to MAX_BATCH
    whatever the shapes: ceil(n / MAX_BATCH) batches (every side here
    reconstructs on one block), bytes equal to the native encoder's."""
    from nicetpu_torch import api
    from nicetpu_torch.config import RuntimeConfig

    stream = texture_patches(mixed_sizes(n, lo, hi), seed=9)
    mb = sum(im.nbytes for im in stream) / 1e6
    label = f"{n} photo texture patches of mixed sizes ({lo}..{hi - 1} a side), round trip"
    native = RuntimeConfig(backend="native")

    def rt_native():
        blobs = api.encode_batch(stream, config=native)
        return blobs, api.decode_batch(blobs, config=native)

    outs, secs_n = timed(rt_native, reps, dev)
    refs = outs[-1][0]
    require(all(np.array_equal(a, im) for _, arrs in outs for a, im in zip(arrs, stream)),
            "config 4: a native round trip differs")
    api.roundtrip_batch(stream[:1], device=dev)  # warm-up
    st: list[dict] = []

    def rt_dev():
        st.append({})
        return api.roundtrip_batch(stream, device=dev, stats=st[-1])

    outs, secs_d = timed(rt_dev, reps, dev)
    require(all(datas == refs for datas, _ in outs), "config 4: device bytes differ from the native encoder's")
    batches = -(-n // api.MAX_BATCH)
    require(all(s["device_batches"] == batches for s in st),
            f"config 4: {[s['device_batches'] for s in st]} device batches a call, not {batches}")
    last = st[-1]
    return [
        line(f"4: {label}, native backend", mb, secs_n, "arrays exact", reps=reps, card=card),
        line(f"4: {label}, {dev.type} roundtrip_batch", mb, secs_d,
             "bytes equal the native encoder's; unverified images proven on the host", reps=reps, card=card,
             fallbacks=_sum(st, "fallbacks"), retries=_sum(st, "retries"),
             overflow_fallbacks=_sum(st, "overflow_fallbacks"),
             verified_on_device=all(v.all() for _, v in outs), device_batches=last["device_batches"],
             pad_pct=100 * (last["batch_pixels"] - last["image_pixels"]) / last["image_pixels"]),
    ]


def config5_rank(comm, side: int, device: str, warm_side: int = CONFIG5_WARM_SIDE) -> dict:
    """One rank of config 5: a warm-up on a warm_side raster, then the
    side x side raster encoded and decoded across the ranks, each timed from
    a barrier with the device synchronized.  The encode's cached device
    blocks are released before the decode.  Returns this rank's times,
    stats, launches, peaks and a digest of its bytes."""
    import torch.distributed as dist

    from nicetpu_torch.dist.sharded import encode_sharded
    from nicetpu_torch.dist.sharded_decode import decode_sharded
    from nicetpu_torch.kernels import cuda_ops, decode3

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    warm = make_img(warm_side, warm_side, CONFIG5_SEED)
    decode_sharded(encode_sharded(warm, device=device), device=device)
    img = make_img(side, side, CONFIG5_SEED)

    def timed_rank(fn):
        sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t0

    cuda_ops.reset_launches()
    es: dict = {}
    ds: dict = {}
    peak_reset(dev)
    data, enc_s = timed_rank(lambda: encode_sharded(img, device=device, stats=es))
    enc_peak = peak_gib(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    peak_reset(dev)
    out, dec_s = timed_rank(lambda: decode_sharded(data, device=device, stats=ds))
    dec_peak = peak_gib(dev)
    return {"rank": comm.rank, "encode_s": enc_s, "decode_s": dec_s, "bytes": len(data),
            "sha256": hashlib.sha256(data).hexdigest(), "payload_bits": decode3.payload_bits(data),
            "raster_equal": bool(np.array_equal(out, img)), "encode_stats": es, "decode_stats": ds,
            "launches": dict(cuda_ops.LAUNCHES), "encode_peak_device_gib": enc_peak,
            "decode_peak_device_gib": dec_peak, "peak_rss_gib": _rss_gib(resource.RUSAGE_SELF)}


def _rss_gib(who) -> float:
    return resource.getrusage(who).ru_maxrss / 2**20  # kB on Linux


@contextlib.contextmanager
def _alloc_conf(value: str | None):
    """PYTORCH_CUDA_ALLOC_CONF for the ranks spawned inside the block.  Four
    ranks on one card: their encodes together come within a few GB of the
    card's memory (on an H100 80GB: about 14 GiB allocated a rank at
    14336x14336, 77 GB in use on the card), and expandable segments keep
    the allocator's partly used blocks from stranding the rest."""
    key = "PYTORCH_CUDA_ALLOC_CONF"
    old = os.environ.get(key)
    if value is not None:
        os.environ[key] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old


def config5_check(res: list[dict], ref: bytes, *, on_card: bool) -> None:
    """Every rank's bytes equal `ref`, its raster is exact, nothing fell
    back, and (on the card, where the kernels count their launches) the
    walk, the value join and the reconstruction ran."""
    digest = hashlib.sha256(ref).hexdigest()
    for r in res:
        require(r["bytes"] == len(ref) and r["sha256"] == digest,
                f"config 5: rank {r['rank']}'s bytes differ from hostref.encode_native")
        require(r["raster_equal"], f"config 5: rank {r['rank']}'s raster differs")
        require(r["encode_stats"]["overflow_fallbacks"] == 0 and r["decode_stats"]["fallbacks"] == 0,
                f"config 5: rank {r['rank']} fell back: {r['encode_stats']} {r['decode_stats']}")
        require(not on_card or all(r["launches"][k] >= 1 for k in ("walk", "value_join", "reconstruct_rows")),
                f"config 5: rank {r['rank']} skipped a decode kernel: {r['launches']}")


def config5_run(dev, *, side: int = CONFIG5_SIDE, ranks: int = CONFIG5_RANKS,
                timeout: float = CONFIG5_TIMEOUT, card: str) -> tuple[dict, np.ndarray, bytes]:
    """Config 5 over `ranks` spawned ranks under a time limit; returns (its
    line, the raster, hostref's bytes of it)."""
    from nicetpu_torch.dist import launch
    from nicetpu_torch.hostref import oracle
    from nicetpu_torch.kernels import decode3

    if dev.type == "cuda" and torch.cuda.device_count() >= ranks:
        backend, where = "nccl", f"NCCL, one rank a card over {ranks} cards"
    elif dev.type == "cuda":
        backend, where = "gloo", f"gloo, {ranks} ranks on one card: time-sliced, no scaling"
    else:
        backend, where = "gloo", f"gloo, {ranks} ranks on the CPU"
    img = make_img(side, side, CONFIG5_SEED)
    t0 = time.perf_counter()
    ref = oracle.encode_native(img)
    ref_s = time.perf_counter() - t0
    if side >= CONFIG5_SIDE:
        bits = decode3.payload_bits(ref)
        require(bits > 2**31, f"config 5: a payload of {bits} bits, not past 2**31")
    t0 = time.perf_counter()
    with _alloc_conf("expandable_segments:True" if backend == "gloo" and dev.type == "cuda" else None):
        res = launch.run(config5_rank, ranks, backend=backend, device=dev.type,
                         args=(side, dev.type, min(side, CONFIG5_WARM_SIDE)), timeout=timeout)
    wall = time.perf_counter() - t0
    for r in res:  # every rank's record, also when a check below fails
        print(json.dumps({k: v for k, v in r.items() if k != "sha256"}), file=sys.stderr, flush=True)
    config5_check(res, ref, on_card=dev.type == "cuda")
    mb = img.nbytes / 1e6
    enc_s = max(r["encode_s"] for r in res)
    dec_s = max(r["decode_s"] for r in res)
    out = {
        "config": f"5: {side}x{side} RGB8 sharded encode + decode over {ranks} ranks ({where})",
        "value": mb / enc_s, "unit": "MB/s",
        "note": (f"value is the encode MB/s over the slowest rank; bytes equal hostref.encode_native "
                 f"on every rank, raster exact; the robust rung {tuple(decode3.LADDER[-1])}"),
        "encode_mbs": mb / enc_s, "decode_mbs": mb / dec_s, "encode_s": enc_s, "decode_s": dec_s,
        "payload_bits": res[0]["payload_bits"], "verified": True, "fallbacks": 0,
        "overflow_fallbacks": 0, "backend": backend, "side": side,
        "ranks": [{k: r[k] for k in ("rank", "encode_s", "decode_s", "encode_peak_device_gib",
                                     "decode_peak_device_gib", "peak_rss_gib", "launches")}
                  | {"encode_stages": r["encode_stats"].get("stages", {}),
                     "decode_stages": r["decode_stats"].get("stages", {})} for r in res],
        "peak_device_gib": max(max(r["encode_peak_device_gib"], r["decode_peak_device_gib"])
                               for r in res) if dev.type == "cuda" else None,
        "host_peak_rss_gib": _rss_gib(resource.RUSAGE_SELF),
        "ranks_peak_rss_gib": _rss_gib(resource.RUSAGE_CHILDREN),
        "reference_encode_s": ref_s, "spawn_wall_s": wall, "reps": 1, "card": card,
    }
    return out, img, ref


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=(1, 2, 3, 4, 5), action="append")
    ap.add_argument("--side", type=int, default=CONFIG5_SIDE, help="config 5's raster side")
    ap.add_argument("--reps", type=int, default=None, help="repeats (default: each config's own)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the bench runs on the card", file=sys.stderr)
        return 1
    dev = prepare(args.device)
    card = card_line()
    reps = {} if args.reps is None else {"reps": args.reps}
    for n in args.config or (1, 2, 3, 4, 5):
        if n == 5:
            lines = [config5_run(dev, side=args.side, card=card)[0]]
        else:
            lines = CONFIGS[n](dev, card=card, **reps)
        for ln in lines:
            print(json.dumps(ln), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
