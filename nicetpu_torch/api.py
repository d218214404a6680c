"""User-facing encode API of the PyTorch port.

The device is always named by the caller: "cuda" runs the CUDA kernels and
raises when CUDA is absent; "cpu" runs the kernels' plain PyTorch versions,
which is the caller's explicit choice, never a fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from nicetpu.api import _to_rgb
from nicetpu_torch import pipeline

MAX_BATCH = 8  # images per fused encode; bounds device memory per call


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was requested but CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def encode(img: np.ndarray, *, device) -> bytes:
    """Encode an (H, W, 3|4) uint8 array to `.nice` bytes (alpha dropped)."""
    return encode_batch([img], device=device)[0]


def encode_batch(imgs: list[np.ndarray], *, device, stats: dict | None = None) -> list[bytes]:
    """Encode a list of (H, W, 3|4) uint8 images; same-shape images share
    batches of up to MAX_BATCH.  Output order follows input order.

    stats: optional dict; receives "device" and "overflow_fallbacks" (the
    number of images the native encoder served because the device path
    could not represent them).
    """
    dev = _resolve_device(device)
    imgs = [_to_rgb(im) for im in imgs]
    if stats is not None:
        stats["device"] = str(dev)
        stats.setdefault("overflow_fallbacks", 0)
    by_shape: dict[tuple, list[int]] = {}
    for i, im in enumerate(imgs):
        by_shape.setdefault(im.shape, []).append(i)
    out: list[bytes | None] = [None] * len(imgs)
    for idxs in by_shape.values():
        for s in range(0, len(idxs), MAX_BATCH):
            chunk = idxs[s : s + MAX_BATCH]
            datas = pipeline.encode_batch_fused(
                [imgs[i] for i in chunk], device=dev, stats=stats
            )
            for i, d in zip(chunk, datas):
                out[i] = d
    return out
