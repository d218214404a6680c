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
"""

from __future__ import annotations

import numpy as np
import torch

from nicetpu_torch import pipeline
from nicetpu_torch.config import BACKENDS, HOST_CODECS, RuntimeConfig
from nicetpu_torch.format import headers
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import decode3, encode2
from nicetpu_torch.spec import codec as spec_codec
from nicetpu_torch.utils.profiling import span

MAX_BATCH = 8  # images per device batch; bounds device memory per call


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was requested but CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def backend_target(backend: str) -> torch.device | str:
    """Where a backend runs: the torch.device of "cuda" or "cpu", or the
    name of the host codec that serves it, "native" or "spec".  "cuda"
    without CUDA raises: no other backend answers in its place."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {BACKENDS}")
    return backend if backend in HOST_CODECS else _resolve_device(backend)


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


def _to_rgb(img: np.ndarray, alpha: str = "drop") -> np.ndarray:
    """Normalize to (H, W, 3) uint8 (the port's copy of `nicetpu.api._to_rgb`).

    The `.nice` wire format cannot round-trip alpha: the reference encoder
    accepts RGBA but its decoder reconstructs 3 bytes/pixel unconditionally
    (ref code.rs:659; SURVEY A.8.3), so reference channels=4 files are
    undecodable even by the reference itself.  This codec therefore always
    writes channels=3; `alpha` controls the RGBA policy:
      "drop"  - discard the alpha plane (the reference encoder's behavior)
      "error" - refuse RGBA input outright
    """
    if img.ndim != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, C) uint8 image")
    if img.shape[2] == 4:
        if alpha == "error":
            raise ValueError(
                "RGBA input refused (alpha='error'): .nice cannot round-trip "
                "alpha (SURVEY A.8.3)"
            )
        if alpha != "drop":
            raise ValueError(f"unknown alpha policy {alpha!r}")
        img = img[:, :, :3]
    if img.shape[2] != 3:
        raise ValueError("expected RGB or RGBA image")
    return np.ascontiguousarray(img)


def _batches(keys: list) -> list[list[int]]:
    """Indices grouped by equal key (input order kept), cut into batches of
    at most MAX_BATCH."""
    groups: dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return [idxs[s : s + MAX_BATCH] for idxs in groups.values() for s in range(0, len(idxs), MAX_BATCH)]


def encode(img: np.ndarray, *, device=None, config=None, alpha: str = "drop") -> bytes:
    """Encode an (H, W, 3|4) uint8 array to `.nice` bytes.

    alpha: the RGBA policy, "drop" (the reference encoder's behaviour) or
    "error" (RGBA input raises ValueError; see `_to_rgb`)."""
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


def roundtrip_batch(imgs: list[np.ndarray], *, device="cuda",
                    stats: dict | None = None) -> tuple[list[bytes], np.ndarray]:
    """Encode images and prove that each blob decodes back to its image.

    Same-shape images share batches of up to MAX_BATCH, each encoded,
    decoded from the resident words and compared on the device
    (`pipeline.roundtrip_batch_resident`).  Returns (datas, verified): the
    `.nice` bytes and a (len(imgs),) bool array, True where the device
    proved the round trip.  The host codec proves the others.

    stats: optional dict; receives "device" and accumulates "retries"
    (images retried on the robust rung), "fallbacks" (images proven on the
    host), "overflow_fallbacks" (images encoded by the host codec) and
    "overflow_decoded" (images decoded on the device although their encode
    had overflowed)."""
    dev = _resolve_device(device)
    imgs = [_to_rgb(im) for im in imgs]
    if stats is not None:
        stats["device"] = str(dev)
        for k in pipeline.ROUNDTRIP_STATS:
            stats.setdefault(k, 0)
    datas: list[bytes | None] = [None] * len(imgs)
    verified = np.zeros(len(imgs), bool)
    with span("api.roundtrip_batch"):
        for chunk in _batches([im.shape for im in imgs]):
            batch = [imgs[i] for i in chunk]
            out, ok = pipeline.roundtrip_batch_resident(
                pipeline.upload_batch(batch, dev), batch, stats=stats
            )
            for j, i in enumerate(chunk):
                datas[i] = out[j]
                verified[i] = ok[j]
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
