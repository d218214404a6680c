"""Seeded generators: one stream a purpose, so that what one part draws
never shifts another's."""

from __future__ import annotations

import zlib

import numpy as np


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A numpy Generator for (seed, purpose); any integer seed, negative
    or past 64 bits included."""
    return np.random.default_rng([int(seed) % (1 << 64), zlib.crc32(purpose.encode())])
