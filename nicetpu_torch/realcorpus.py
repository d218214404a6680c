"""The real-photo corpus: eight natural images, read from the `.nice` files
in `nicetpu_torch/data/realcorpus/` (counterpart of `nicetpu/realcorpus.py`).

The JAX module reads the images from the Python packages that ship them
(JPEG and PNG through PIL); the port carries them as `.nice` streams of
their full-size RGB pixels, written once by `hostref.encode_native` from
the JAX `load_corpus()` (see `data/realcorpus/SOURCES.md` for each origin
and license), and decodes them with its own host codec: no PIL, no
site-packages paths.
"""

from __future__ import annotations

import os

import numpy as np

from nicetpu_torch.hostref import oracle

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "realcorpus")
# the names and order of the JAX corpus: a portrait photo, three camera
# shots, three photographic textures and one soccer jersey texture
NAMES = ("hopper", "camera_rgb", "camera_hsv", "camera_avg", "wood", "marble", "skin", "soccer0")


def path(name: str) -> str:
    """The `.nice` file of one corpus image."""
    return os.path.join(DATA, f"{name}.nice")


def read_bytes(name: str) -> bytes:
    with open(path(name), "rb") as f:
        return f.read()


def load_corpus(max_dim: int | None = None) -> list[tuple[str, np.ndarray]]:
    """The corpus as (name, (H, W, 3) uint8) pairs, in order.

    max_dim: optionally centre-crop to at most max_dim on each side (keeps
    bench runtimes bounded for the big textures), as the JAX function
    does."""
    out: list[tuple[str, np.ndarray]] = []
    for name in NAMES:
        img = oracle.decode_native(read_bytes(name))
        if max_dim is not None and (img.shape[0] > max_dim or img.shape[1] > max_dim):
            h0 = (img.shape[0] - min(img.shape[0], max_dim)) // 2
            w0 = (img.shape[1] - min(img.shape[1], max_dim)) // 2
            img = img[h0 : h0 + max_dim, w0 : w0 + max_dim]
        out.append((name, np.ascontiguousarray(img)))
    return out
