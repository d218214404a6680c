"""User-facing API of the PyTorch port: encode, decode, the verified round
trip and the PNG bridges.

Every entry point runs on the card unless the caller asks otherwise, by
`device=` or by a `RuntimeConfig`'s backend (explicit device > config >
NICETPU_BACKEND > "cuda"):
    "cuda"    the CUDA kernels; raises when CUDA is absent;
    "cpu"     the kernels' plain PyTorch versions, the caller's explicit
              choice, never a fallback;
    "native"  (a backend only) the port's C++ host codec, `hostref`;
    "spec"    (a backend only) the port's numpy reference codec,
              `spec.codec`, image by image.
No backend answers for another: a host codec runs only when it is named.

`ShardGroup` (from `dist.group`) is the sharded path: a persistent group of
ranks, one a card, that encodes, decodes and round-trips one raster a call
across them.
"""

from __future__ import annotations

import numpy as np
import torch

from nicetpu_torch import pipeline
from nicetpu_torch.config import RuntimeConfig, backend_target
from nicetpu_torch.config import resolve_device as _resolve_device
from nicetpu_torch.convert import to_rgb as _to_rgb
from nicetpu_torch.dist.group import ShardGroup  # noqa: F401  (the api's sharded path)
from nicetpu_torch.format import headers
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import decode3, encode2, recon
from nicetpu_torch.spec import codec as spec_codec
from nicetpu_torch.utils.profiling import span

MAX_BATCH = 8  # images per device batch; bounds device memory per call
# what `roundtrip_batch` counts of its device batches: the batches, the
# images' pixels, and the pixels the batches hold (B x the largest image's)
BATCH_STATS = ("device_batches", "image_pixels", "batch_pixels")


def target(device, config) -> torch.device | str:
    """Explicit device > config > NICETPU_BACKEND > "cuda" (see
    `backend_target`)."""
    if device is not None:
        return _resolve_device(device)
    return backend_target((config or RuntimeConfig.from_env()).backend)


def _host_encode(codec: str, imgs: list[np.ndarray]) -> list[bytes]:
    if codec == "native":
        return oracle.encode_batch_native(imgs)
    return [spec_codec.encode(im) for im in imgs]


def _host_decode(codec: str, datas: list[bytes]) -> list[np.ndarray]:
    if codec == "native":
        return oracle.decode_batch_native(datas)
    return [spec_codec.decode(d) for d in datas]


def _batches(keys: list, order=None) -> list[list[int]]:
    """Indices grouped by equal key (in `order`, default the input order),
    cut into batches of at most MAX_BATCH."""
    groups: dict = {}
    for i, k in zip(range(len(keys)) if order is None else order, keys):
        groups.setdefault(k, []).append(i)
    return [idxs[s : s + MAX_BATCH] for idxs in groups.values() for s in range(0, len(idxs), MAX_BATCH)]


def plan_batches(imgs: list[np.ndarray], device) -> list[list[int]]:
    """The round trip's device batches: the images sorted, stably, by
    pixel count, largest first, and cut into batches of at most MAX_BATCH
    whatever their shapes, so that images of like size share a batch and
    its padding stays small.  Images whose chains reconstruct on different
    paths (`recon.chain_path`: one block, a cluster, device-memory scratch)
    never share one.  A same-shape call gets `_batches`'s batches."""
    with span("api.plan_batches"):
        order = sorted(range(len(imgs)), key=lambda i: -imgs[i].shape[0] * imgs[i].shape[1])
        paths = [recon.chain_path(im.shape[1], device) for im in imgs]
        return _batches([paths[i] for i in order], order)


def encode(img: np.ndarray, *, device=None, config=None, alpha: str = "drop") -> bytes:
    """Encode an (H, W, 3|4) uint8 array to `.nice` bytes.

    alpha: the RGBA policy, "drop" (the reference encoder's behaviour) or
    "error" (RGBA input raises ValueError; see `convert.to_rgb`)."""
    return encode_batch([_to_rgb(img, alpha)], device=device, config=config)[0]


def encode_batch(imgs: list[np.ndarray], *, device=None, config=None,
                 stats: dict | None = None) -> list[bytes]:
    """Encode a list of (H, W, 3|4) uint8 images; same-shape images share
    batches of up to MAX_BATCH.  Output order follows input order.

    On a device each batch takes the two-step encode (`encode2.encode_batch`:
    tokenizer and histogram, Huffman tables built on the host, join, fold
    and place), which keeps every image on the device, as the JAX
    `api.encode_batch` does.

    stats: optional dict; receives "device", "overflow_fallbacks" (images
    the native encoder served: none on this path), "retokenized" (images
    tokenized again with all 11 run digits) and "slot_mode" (batches packed
    slot by slot), or {"backend": "native" | "spec"} when the config's
    backend is a host codec.
    """
    dev = target(device, config)
    imgs = [_to_rgb(im) for im in imgs]
    if isinstance(dev, str):
        if stats is not None:
            stats["backend"] = dev
        return _host_encode(dev, imgs)
    if stats is not None:
        stats["device"] = str(dev)
        for k in ("overflow_fallbacks", "retokenized", "slot_mode"):
            stats.setdefault(k, 0)
    out: list[bytes | None] = [None] * len(imgs)
    with span("api.encode_batch"):
        for chunk in _batches([im.shape for im in imgs]):
            datas = encode2.encode_batch(np.stack([imgs[i] for i in chunk]), device=dev, stats=stats)
            for i, d in zip(chunk, datas):
                out[i] = d
    return out


def decode(data: bytes, *, device=None, config=None) -> np.ndarray:
    """Decode `.nice` bytes to an (H, W, 3) uint8 array."""
    return decode_batch([data], device=device, config=config)[0]


def decode_batch(datas: list[bytes], *, device=None, config=None, chunk_bits: int | None = None,
                 stats: dict | None = None) -> list[np.ndarray]:
    """Decode `.nice` streams; same-shape streams share device batches of up
    to MAX_BATCH, each through the retry ladder (`decode3.decode_batch_v3`).
    A stream no rung verifies is decoded on the host.  chunk_bits, when
    given, sets every rung's chunk size.

    stats: optional dict; receives "device" and accumulates "retries" (rungs
    retried) and "fallbacks" (streams the host decoded), or {"backend":
    "native" | "spec"} when the config's backend is a host codec."""
    dev = target(device, config)
    if isinstance(dev, str):
        if stats is not None:
            stats["backend"] = dev
        return _host_decode(dev, list(datas))
    if stats is not None:
        stats["device"] = str(dev)
        stats.setdefault("retries", 0)
        stats.setdefault("fallbacks", 0)
    out: list[np.ndarray | None] = [None] * len(datas)
    with span("api.decode_batch"):
        for chunk in _batches([headers.parse_file_header(d)[:2] for d in datas]):
            sub: dict = {}
            arrs = decode3.decode_batch_v3([datas[i] for i in chunk], device=dev,
                                           chunk_bits=chunk_bits, stats=sub)
            for i, a in zip(chunk, arrs):
                out[i] = a
            if stats is not None:
                stats["retries"] += sub["retries"]
                stats["fallbacks"] += sub["fallbacks"]
    return out


def roundtrip_batch(imgs: list[np.ndarray], *, device="cuda", stats: dict | None = None,
                    marks=None) -> tuple[list[bytes], np.ndarray]:
    """Encode images and prove that each blob decodes back to its image.

    The images, of any shapes, share device batches of up to MAX_BATCH
    (`plan_batches`: largest first), each encoded, decoded from the
    resident words and compared on the device, each image at its own
    geometry (`pipeline.roundtrip_batch_resident`).  Returns (datas,
    verified) in input order: the `.nice` bytes and a (len(imgs),) bool
    array, True where the device proved the round trip.  The host codec
    proves the others.

    stats: optional dict; receives "device" and accumulates "retries"
    (images retried on the robust rung), "fallbacks" (images proven on the
    host), "overflow_fallbacks" (images encoded by the host codec),
    "overflow_decoded" (images decoded on the device although their encode
    had overflowed) and BATCH_STATS: "device_batches", "image_pixels" (the
    images' pixels) and "batch_pixels" (each batch's images times its
    largest image's pixels, the padded pixels the device took).

    marks: optional list receiving (stage, CUDA event) pairs, each batch's
    stages in turn (`pipeline.roundtrip_batch_resident`)."""
    dev = _resolve_device(device)
    imgs = [_to_rgb(im) for im in imgs]
    if stats is not None:
        stats["device"] = str(dev)
        for k in pipeline.ROUNDTRIP_STATS + BATCH_STATS:
            stats.setdefault(k, 0)
    datas: list[bytes | None] = [None] * len(imgs)
    verified = np.zeros(len(imgs), bool)
    with span("api.roundtrip_batch"):
        for chunk in plan_batches(imgs, dev):
            batch = [imgs[i] for i in chunk]
            out, ok = pipeline.roundtrip_batch_resident(
                pipeline.upload_batch(batch, dev), batch, stats=stats, marks=marks
            )
            for j, i in enumerate(chunk):
                datas[i] = out[j]
                verified[i] = ok[j]
            if stats is not None:
                n = [im.shape[0] * im.shape[1] for im in batch]
                stats["device_batches"] += 1
                stats["image_pixels"] += sum(n)
                stats["batch_pixels"] += len(n) * max(n)
    return datas, verified


def imread(path: str) -> np.ndarray:
    """Read a PNG (or any PIL-supported image) as (H, W, 3|4) uint8."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode not in ("RGB", "RGBA"):
            im = im.convert("RGB")
        return np.asarray(im, dtype=np.uint8)


def imwrite(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)
