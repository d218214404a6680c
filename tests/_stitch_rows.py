"""Shard layouts for the stitch (`cuda_ops.stitch_file`), numpy and the port
only: the CPU tests, the card tests and `chip_smoke.py` share them.

A case is (bit totals a shard, words a shard).  `shards` fills each row
with seeded words and leaves the bits past its total zero, as the encoder
does (or random, with garbage=True)."""

from __future__ import annotations

import numpy as np
import torch

# name -> (bit totals, words a shard)
CASES = {
    "one-shard-ragged": ([32 * 37 + 5], 40),
    "one-shard-aligned": ([32 * 40], 40),
    "two-ragged": ([32 * 21 + 13, 32 * 30 + 7], 32),
    "two-aligned": ([32 * 16, 32 * 25], 25),
    "four-ragged": ([32 * 50 + 3, 32 * 44 + 29, 32 * 61 + 1, 32 * 47 + 16], 64),
    "four-byte-total": ([32 * 9 + 8, 32 * 11 + 16, 32 * 3 + 24, 32 * 7], 12),
    "four-one-empty": ([32 * 33 + 9, 0, 32 * 28 + 31, 32 * 19 + 2], 34),
    "four-under-32": ([3, 17, 1, 29], 2),
    "under-32-between": ([32 * 20 + 11, 5, 32 * 18 + 30, 7], 24),
    "all-empty": ([0, 0, 0, 0], 1),
    "empty-first-and-last": ([0, 32 * 10 + 4, 32 * 12 + 20, 0], 13),
}
# header lengths: a .nice file's (770, 2 past a 16-byte chunk), one chunk
# apart, shorter than a chunk, none
HEADER_LENGTHS = (770, 16, 13, 0)


def header(length: int, seed: int = 0) -> bytes:
    return np.random.default_rng(1000 + seed).integers(0, 256, length, dtype=np.uint8).tobytes()


def shards(bits, k: int, seed: int = 0, garbage: bool = False) -> torch.Tensor:
    """(n, k) int32 words: row d holds bits[d] seeded bits, then zeros
    (random bits with garbage=True)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (len(bits), k), dtype=np.uint64).astype(np.uint32)
    if not garbage:
        for d, b in enumerate(bits):
            words[d, -(-b // 32) :] = 0
            if b % 32:
                words[d, b // 32] &= np.uint32((0xFFFFFFFF << (32 - b % 32)) & 0xFFFFFFFF)
    return torch.from_numpy(words.view(np.int32))


def random_bits(n: int, words_per: int, seed: int) -> np.ndarray:
    """n seeded totals, each within its shard's 32 * words_per bits."""
    rng = np.random.default_rng(seed)
    return rng.integers(max(0, 32 * words_per - 4096), 32 * words_per + 1, n).astype(np.int64)


def bit_string(words: torch.Tensor, bits) -> str:
    """The stitched payload as '0'/'1': each row's first bits[d] bits in
    order (slow; small cases only)."""
    rows = words.numpy().view(np.uint32)
    return "".join("".join(f"{int(w):032b}" for w in rows[d])[: int(b)] for d, b in enumerate(bits))
