"""Canonical Huffman code construction and code-length validation.

The benchmark's frozen copy of the plain parts of
`nicetpu_torch/format/huffman.py`: the Python code-length merge
(`_huffman_lengths_once`, `clamp_floor`, `code_lengths`), the canonical code
assignment (`canonical_codes`), the spec decoder's tables (`decode_lut`,
`canonical_decode_tables`) and the flat per-stream tables
(`build_all_tables`).  The C++ merge and the header check of the program's
copy are left out: the reference runs no code of the program.

Semantics follow the reference (SURVEY §2.3): a full-alphabet Huffman merge
including zero-count symbols, at least 1 bit a code; ties among
equal-weight nodes break by (total count, smallest symbol under the node),
as the C++ oracle and the on-device tables do, so every encoder of the
repository writes the same bytes; canonical codes count up in (length asc,
symbol asc) order.
"""

from __future__ import annotations

import heapq

import numpy as np

from benchmark.reference import constants as C


def _huffman_lengths_once(counts: np.ndarray) -> np.ndarray:
    """One minimum-variance Huffman merge pass -> (n,) int64 lengths >= 1."""
    n = int(counts.shape[0])
    lengths = np.ones(n, dtype=np.int64)
    # Heap entries: (weight, is_internal, min_symbol, [symbol ids under node]).
    # Leaves pop before equal-weight internal nodes (minimum-variance Huffman:
    # the optimal total with the smallest max depth).
    heap: list[tuple[int, int, int, list[int]]] = [
        (int(counts[i]), 0, i, [i]) for i in range(n)
    ]
    heapq.heapify(heap)
    # Stop at 2 nodes: the root merge is accounted for by the aob=1 start.
    while len(heap) > 2:
        w1, _, m1, s1 = heapq.heappop(heap)
        w2, _, m2, s2 = heapq.heappop(heap)
        merged = s1 + s2
        lengths[merged] += 1
        heapq.heappush(heap, (w1 + w2, 1, min(m1, m2), merged))
    return lengths


def clamp_floor(total: int) -> int:
    """Minimum weight enforced by the length-limiting clamp: >= total/2^20.

    Clamping every count (including zeros) to this floor bounds the Huffman
    depth by the Fibonacci weight bound, so the re-merged depth is <= 31.
    Shared by the C++ oracle and the on-device tables."""
    return (int(total) >> 20) + 1


def code_lengths(counts: np.ndarray) -> np.ndarray:
    """Optimal Huffman code lengths (>= 1 bit) for a full alphabet.

    counts: (n,) nonnegative ints, n >= 2.  Returns (n,) uint8 lengths.
    When the unrestricted optimum exceeds the 31-bit limit of the 5-bit
    max_aob header field, all counts are clamped up to `clamp_floor(total)`
    and the merge re-run.
    """
    counts = np.asarray(counts, dtype=np.int64)
    if counts.shape[0] < 2:
        raise ValueError("alphabet must have >= 2 symbols")
    lengths = _huffman_lengths_once(counts)
    if int(lengths.max()) > C.MAX_CODE_LEN:
        lengths = _huffman_lengths_once(np.maximum(counts, clamp_floor(counts.sum())))
        if int(lengths.max()) > C.MAX_CODE_LEN:
            raise RuntimeError("the clamped Huffman merge exceeded the code-length limit")
    return lengths.astype(np.uint8)


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes for given lengths: (len asc, symbol asc), counting up.

    Returns (n,) uint32 codes, each valid in its low `lengths[i]` bits."""
    lengths = np.asarray(lengths, dtype=np.int64)
    n = lengths.shape[0]
    order = np.lexsort((np.arange(n), lengths))  # length asc, symbol asc
    codes = np.zeros(n, dtype=np.uint32)
    code = 0
    prev_len = 0
    for sym in order:
        ln = int(lengths[sym])
        if prev_len:
            code = (code + 1) << (ln - prev_len)
        codes[sym] = code
        prev_len = ln
    return codes


def decode_lut(lengths: np.ndarray, codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One-shot decoder LUT: (symbol, aob) for every max_aob-bit prefix.

    Mirrors ref hfe.rs:191-202: entry x = the unique code that prefixes x.
    Returns (symbols uint16 (2^max_aob,), aobs uint8 (2^max_aob,))."""
    lengths = np.asarray(lengths, dtype=np.int64)
    codes = np.asarray(codes, dtype=np.uint32)
    max_aob = int(lengths.max())
    if max_aob > C.MAX_LUT_AOB:
        raise OverflowError(f"max_aob {max_aob} too large for one-shot LUT")
    size = 1 << max_aob
    symbols = np.zeros(size, dtype=np.uint16)
    aobs = np.zeros(size, dtype=np.uint8)
    for sym in range(lengths.shape[0]):
        ln = int(lengths[sym])
        lo = int(codes[sym]) << (max_aob - ln)
        hi = (int(codes[sym]) + 1) << (max_aob - ln)
        symbols[lo:hi] = sym
        aobs[lo:hi] = ln
    return symbols, aobs


def canonical_decode_tables(
    lengths: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tables for LUT-free canonical decoding of arbitrarily deep codes.

    Returns (sorted_symbols, index_base, aligned_first):
      sorted_symbols: symbols in (length asc, symbol asc) order (uint16)
      index_base[l]:  index into sorted_symbols of the first length-l symbol
      aligned_first[l]: first length-l code left-aligned to 32 bits (uint64)
    Decode: align the peeked max_aob bits to 32; pick the largest present
    length l with aligned >= aligned_first[l]; then
    symbol = sorted_symbols[index_base[l] + ((aligned - aligned_first[l]) >> (32-l))]."""
    lengths = np.asarray(lengths, dtype=np.int64)
    codes = canonical_codes(lengths)
    n = lengths.shape[0]
    order = np.lexsort((np.arange(n), lengths))
    sorted_symbols = order.astype(np.uint16)
    index_base = np.zeros(C.MAX_CODE_LEN + 2, dtype=np.int64)
    aligned_first = np.full(C.MAX_CODE_LEN + 2, np.iinfo(np.uint64).max, dtype=np.uint64)
    for idx, sym in enumerate(order):
        ln = int(lengths[sym])
        if aligned_first[ln] == np.iinfo(np.uint64).max:
            index_base[ln] = idx
            aligned_first[ln] = np.uint64(int(codes[sym]) << (32 - ln))
    return sorted_symbols, index_base, aligned_first


def build_all_tables(flat_counts: np.ndarray) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """Per-stream tables from a flat (TOTAL_SYMBOLS,) histogram with the
    Python code-length merge: (flat_lengths uint8, flat_codes uint32, max_aobs
    per stream) in the flat STREAM_BASE layout.  The plain version that the
    tests hold `build_tables_host` against."""
    flat_counts = np.asarray(flat_counts)
    flat_lengths = np.zeros(C.TOTAL_SYMBOLS, dtype=np.uint8)
    flat_codes = np.zeros(C.TOTAL_SYMBOLS, dtype=np.uint32)
    max_aobs: list[int] = []
    for s in range(C.NUM_STREAMS):
        base = C.STREAM_BASE[s]
        size = C.ALPHABET_SIZES[s]
        lens = code_lengths(flat_counts[base : base + size])
        flat_lengths[base : base + size] = lens
        flat_codes[base : base + size] = canonical_codes(lens)
        max_aobs.append(int(lens.max()))
    return flat_lengths, flat_codes, max_aobs
