"""What the calls share: raw sizes, RGB views, digests, and the control's
lossy step (the lowest bit of every byte dropped, a near-lossless codec)."""

from __future__ import annotations

import hashlib

import numpy as np


def rgb(image: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(image[:, :, :3])


def raw_bytes(image: np.ndarray) -> int:
    return int(image.shape[0]) * int(image.shape[1]) * 3


def lossy(image: np.ndarray) -> np.ndarray:
    return rgb(image) & np.uint8(0xFE)


def bytes_digest(answer) -> str | None:
    """SHA-256 of a `.nice` answer; None for anything that is not bytes."""
    if not isinstance(answer, (bytes, bytearray)):
        return None
    return hashlib.sha256(answer).hexdigest()


def pixels_digest(answer) -> tuple | None:
    """(shape, dtype, SHA-256 of the pixels) of an array answer; None for
    anything else."""
    if not isinstance(answer, np.ndarray):
        return None
    return (answer.shape, str(answer.dtype), hashlib.sha256(np.ascontiguousarray(answer)).hexdigest())
