"""Histogram rows for the Huffman table builders, made with numpy from a
seed.  Imports no JAX, so that the card's tests (`test_torch_cuda.py`) and
`chip_smoke.py` hold the kernel on the same rows as the CPU parity tests.

Every function returns a (3, 858) int64 batch: the parity tests run JAX's
`build_tables_device` on batches of 3, so that it compiles once.
"""

import numpy as np

from nicetpu_torch.format import constants as C


def _fib(n):
    f = [1, 1]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return np.asarray(f[:n], np.int64)


def _random(seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 5000, C.TOTAL_SYMBOLS) for _ in range(3)])


def _sparse(seed):
    rng = np.random.default_rng(seed)
    rows = np.zeros((3, C.TOTAL_SYMBOLS), np.int64)
    for r in rows:
        r[rng.integers(0, C.TOTAL_SYMBOLS, 25)] = rng.integers(1, 10**6, 25)
    return rows


def _deep():
    """Deep-code fixture.  Every symbol has a count, so only the Fibonacci
    streams run deep: row 0 puts Fibonacci counts on the 32-symbol
    LUMA_OTHER_DIFF stream (a chain of codes 1..31 bits long, just inside
    the limit); row 1 puts 40 of them on the 64-symbol LUMA_BASE_DIFF
    stream (the other 24 symbols heavier still, so the chain stays whole),
    whose raw merge passes 31 bits, so the clamp + re-merge runs;
    row 2 scatters 40 over the 343-symbol SMALL_DIFF stream (codes past
    15 bits among 342 others, no clamp)."""
    rng = np.random.default_rng(4)
    rows = rng.integers(1, 1000, (3, C.TOTAL_SYMBOLS)).astype(np.int64)
    b3 = C.STREAM_BASE[C.SC_LUMA_OTHER_DIFF]
    rows[0, b3 : b3 + 32] = _fib(32)
    b2 = C.STREAM_BASE[C.SC_LUMA_BASE_DIFF]
    rows[1, b2 : b2 + 64] = np.concatenate([np.full(24, _fib(37)[-1]), _fib(40)])
    b5 = C.STREAM_BASE[C.SC_SMALL_DIFF]
    rows[2, b5 + rng.permutation(343)[:40]] = _fib(40)
    return rows


def _zero():
    """An all-zero histogram, then one count on a single symbol, then one on
    the last symbol of every stream: every leaf weighs 0 or nearly, so the
    merge orders by the leaf bit and the least symbol alone."""
    rows = np.zeros((3, C.TOTAL_SYMBOLS), np.int64)
    rows[1, 300] = 1
    rows[2, np.asarray(C.STREAM_BASE) + np.asarray(C.ALPHABET_SIZES) - 1] = 1
    return rows


def _heavy(seed):
    """One heavy symbol a stream among light ones (a different symbol in each
    row): the heavy leaf takes a 1-bit code and the rest stay balanced."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4, (3, C.TOTAL_SYMBOLS)).astype(np.int64)
    for r in rows:
        for base, size in zip(C.STREAM_BASE, C.ALPHABET_SIZES):
            r[base + rng.integers(0, size)] = 10**6
    return rows


def _ties(seed):
    """Equal-weight internal nodes out of creation order.  In each row one
    stream holds leaves 0-3 of weight 1, leaf 4 of weight 4 and leaves 5-6
    of weight 2, its other symbols heavy: 5 + 6 merge into Z (weight 4,
    least symbol 5) before 0 + 1 and 2 + 3 make V (weight 4, least symbol
    0), yet V orders before Z and pairs with leaf 4, while Z waits for a
    later step.  A Huffman construction that keeps internal nodes in
    creation order would pair leaf 4 with Z and give symbols 0-6 other
    lengths.  The pattern sits in an 11-symbol stream (LUMA_BACK_REF), the
    343-symbol SMALL_DIFF and the last stream (BACK_REF), one a row."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1000, 2000, (3, C.TOTAL_SYMBOLS)).astype(np.int64)
    for r, s in zip(rows, (C.SC_LUMA_BACK_REF, C.SC_SMALL_DIFF, C.SC_BACK_REF)):
        r[C.STREAM_BASE[s] : C.STREAM_BASE[s] + 7] = (1, 1, 1, 1, 4, 2, 2)
    return rows


def _bounds(seed):
    """Stream totals at the edge of the kernel's int keys (below 2^20): in
    row 0 every stream sums to 2^20 - 1 with some empty symbols, so the
    clamped counts pass 2^20 while the raw ones stay below; in row 1 every
    stream sums to 2^20; in row 2 to 2^20 - 1 with no empty symbol."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((3, C.TOTAL_SYMBOLS), np.int64)
    for base, size in zip(C.STREAM_BASE, C.ALPHABET_SIZES):
        for r, (low, total) in enumerate([(0, 2**20 - 1), (0, 2**20), (1, 2**20 - 1)]):
            c = rng.integers(low, 50, size)
            if low == 0:
                c[0] = 0  # an empty symbol, which the clamp raises to 1
            c[-1] = total - c[:-1].sum()
            rows[r, base : base + size] = c
    return rows
