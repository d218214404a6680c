"""Code-length rows for the decode table builders (`prepare_tables_v3`,
`derive_walk_tables`), made with numpy from a seed.  Imports no JAX, so that
the card's tests (`test_torch_cuda.py`) and `chip_smoke.py` hold the kernels
on the same rows as the CPU parity tests.

`LENGTH_ROWS` maps a name to a function that returns a (B, 858) int64 batch
of code lengths; `INT64_ONLY` names the rows whose values do not fit int32.
`WALK_ROWS` maps a name to a function that returns (af, present, ib), each
(B, 10, 32) int32, arbitrary words for `derive_walk_tables`.
"""

import numpy as np

from nicetpu_torch.bench import make_image
from nicetpu_torch.format import constants as C
from nicetpu_torch.format import headers, huffman
from nicetpu_torch.hostref import oracle

KRAFT = 1 << 32  # a complete stream's sum of 2^(32 - length)


def _tables(counts):
    return np.stack([huffman.build_all_tables(c)[0] for c in counts]).astype(np.int64)


def _stream(s):
    return slice(C.STREAM_BASE[s], C.STREAM_BASE[s] + C.ALPHABET_SIZES[s])


def kraft_sums(lens) -> np.ndarray:
    """(B, 858) lengths -> (B, 10) Kraft sums of the clamped lengths, exact."""
    lc = np.clip(np.asarray(lens, np.int64), 1, C.MAX_CODE_LEN)
    out = np.zeros((lc.shape[0], C.NUM_STREAMS), dtype=object)
    for s in range(C.NUM_STREAMS):
        for b in range(lc.shape[0]):
            out[b, s] = sum(1 << (32 - int(v)) for v in lc[b, _stream(s)])
    return out


def valid(seed, B=3):
    """Huffman lengths of random counts (`build_all_tables`)."""
    rng = np.random.default_rng(seed)
    return _tables(rng.integers(0, 50, (B, C.TOTAL_SYMBOLS)))


def sparse(seed):
    """Lengths of counts with some 25 nonzero symbols: most streams take the
    floor's deep balanced codes."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((3, C.TOTAL_SYMBOLS), np.int64)
    for r in counts:
        r[rng.integers(0, C.TOTAL_SYMBOLS, 25)] = rng.integers(1, 10**6, 25)
    return _tables(counts)


def make_image_rows():
    """The lengths of three seeded 64x64 `make_image` encodes."""
    out = []
    for seed in (3, 4, 5):
        data = oracle.encode_native(make_image(64, 64, seed))
        out.append(headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :]))
    return np.stack(out).astype(np.int64)


def soccer0():
    """The lengths of soccer0's committed stream (mostly run digits)."""
    from nicetpu_torch import realcorpus

    data = realcorpus.read_bytes("soccer0")
    return headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :]).astype(np.int64)[None]


def _fib(n):
    f = [1, 1]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return np.asarray(f[:n], np.int64)


def _deep_stream(n, rng):
    """n lengths of a complete code as deep as n allows, up to 31 bits: a
    chain 1..k, then the other r = n - k symbols as a balanced subtree under
    the chain's last node (lengths k + ceil(log2 r) at most), in a random
    symbol order."""
    k = max(k for k in range(n) if k + int(np.ceil(np.log2(n - k))) <= C.MAX_CODE_LEN)
    r = n - k
    q = r.bit_length() - 1
    n_low = 2 ** (q + 1) - r if r != 2**q else r  # leaves at depth k + q; the rest at k + q + 1
    lens = np.concatenate([np.arange(1, k + 1), np.full(n_low, k + q), np.full(r - n_low, k + q + 1)])
    return rng.permutation(lens)


def deep():
    """Codes up to 31 bits: Fibonacci counts make a Huffman chain of
    lengths 1..31 on the 32-symbol LUMA_OTHER_DIFF stream (row 0); in rows 1
    and 2 every stream is a chain as deep as its size allows (31 bits for
    the streams of 32 symbols or more, n - 1 for the 13- and 11-symbol
    ones), its symbols in a random order."""
    rng = np.random.default_rng(4)
    counts = rng.integers(1, 1000, (3, C.TOTAL_SYMBOLS)).astype(np.int64)
    counts[0, _stream(C.SC_LUMA_OTHER_DIFF)] = _fib(32)
    rows = _tables(counts)
    for b in (1, 2):
        for s, n in enumerate(C.ALPHABET_SIZES):
            rows[b, _stream(s)] = _deep_stream(n, rng)
    return rows


def single_length():
    """Streams whose symbols all share one length: every power-of-two stream
    at log2 of its size (complete); row 1 adds the 13-symbol prefix stream
    all at 4 bits (under), row 2 the 11-symbol streams all at 31 bits
    (under)."""
    rows = valid(21)
    for s, n in enumerate(C.ALPHABET_SIZES):
        if n & (n - 1) == 0:
            rows[:, _stream(s)] = n.bit_length() - 1
    rows[1, _stream(C.SC_PREFIXES)] = 4
    rows[2, _stream(C.SC_LUMA_BACK_REF)] = 31
    rows[2, _stream(C.SC_BACK_REF)] = 31
    return rows


def bad_values():
    """Lengths out of 1..31 in otherwise valid tables: 0 (row 0), 32 (row 1),
    -1 (row 2), each in a different stream."""
    rows = valid(23)
    rows[0, C.STREAM_BASE[2] + 5] = 0
    rows[1, C.STREAM_BASE[5] + 100] = 32
    rows[2, C.STREAM_BASE[9] + 10] = -1
    return rows


def past_2_32():
    """int64 lengths past 2^32 whose low words are the valid lengths they
    replace: 2^32 + l (row 0), l - 2^32 (row 1), 2^33 + l in every stream
    (row 2).  A reader that wraps them to int32 sees valid tables; each must
    clear tables_ok and clamp to 31 or 1."""
    rows = valid(25)
    rows[0, 17] += 1 << 32
    rows[1, C.STREAM_BASE[5] + 3] -= 1 << 32
    rows[2, np.asarray(C.STREAM_BASE)] += 1 << 33
    return rows


def kraft():
    """In-range lengths whose Kraft sums miss 2^32: under (row 0, one length
    one bit longer), over (row 1, one length one bit shorter) and exactly
    2 * 2^32 (row 2, RGB's 256 symbols all at 7 bits), which JAX's int32 sum
    wraps to 0 and accepts."""
    rows = valid(27)
    b3 = C.STREAM_BASE[3]
    i = b3 + int(np.argmin(rows[0, _stream(3)]))
    rows[0, i] += 1
    j = b3 + int(np.argmax(rows[1, _stream(3)]))
    rows[1, j] -= 1
    rows[2, _stream(C.SC_RGB)] = 7
    return rows


def _runs(counts: dict, run: int) -> np.ndarray:
    """Lengths in runs of `run` equal symbols, cycling over the lengths of
    `counts` (length -> symbols) until each has its count."""
    left, out = dict(counts), []
    while any(left.values()):
        for ln in left:
            k = min(run, left[ln])
            out += [ln] * k
            left[ln] -= k
    return np.asarray(out, np.int64)


def straddle():
    """Complete codes whose runs of equal lengths cross the 32-symbol chunk
    boundaries of the widest streams: RGB (256 symbols) at 7, 8 and 9 bits
    and stream 5 (343 symbols) at 8 and 9 bits, in runs of 37 and 23 (row
    0), of 13 and 45 symbols reversed (row 1)."""
    rows = valid(35, 2)
    rows[0, _stream(C.SC_RGB)] = _runs({9: 100, 8: 106, 7: 50}, 37)
    rows[0, _stream(5)] = _runs({9: 174, 8: 169}, 23)
    rows[1, _stream(C.SC_RGB)] = _runs({7: 50, 8: 106, 9: 100}, 13)
    rows[1, _stream(5)] = _runs({8: 169, 9: 174}, 45)[::-1]
    return rows


LENGTH_ROWS = {
    "valid": lambda: valid(7), "sparse": lambda: sparse(8), "make_image": make_image_rows, "soccer0": soccer0,
    "deep": deep, "single_length": single_length, "bad_values": bad_values, "past_2_32": past_2_32,
    "kraft": kraft, "straddle": straddle, "B=1": lambda: valid(31, 1), "B=33": lambda: valid(33, 33),
}
INT64_ONLY = ("past_2_32",)


def random_words(seed):
    """Arbitrary int32 af and ib; present 0 or any nonzero word; row 1's
    stream 4 has no present length, row 2's stream 7 every length."""
    rng = np.random.default_rng(seed)
    shape = (3, C.NUM_STREAMS, 32)
    af = rng.integers(-(2**31), 2**31, shape).astype(np.int32)
    ib = rng.integers(-(2**31), 2**31, shape).astype(np.int32)
    present = np.where(rng.random(shape) < 0.4, rng.integers(-(2**31), 2**31, shape), 0).astype(np.int32)
    present[1, 4] = 0
    present[2, 7] = 1
    return af, present, ib


def edge_words():
    """Words at the edges: af of 0, -1 and the sign bit alone; ib of
    INT32_MIN and INT32_MAX; only length 0 present (row 0, stream 0), only
    length 31 (row 0, stream 1), no length (row 1)."""
    shape = (2, C.NUM_STREAMS, 32)
    rng = np.random.default_rng(41)
    af = rng.choice(np.asarray([0, -1, -(2**31), 2**31 - 1], np.int32), shape)
    ib = rng.choice(np.asarray([-(2**31), 2**31 - 1, 0, 1], np.int32), shape)
    present = (rng.random(shape) < 0.5).astype(np.int32)
    present[0, 0] = 0
    present[0, 0, 0] = 1
    present[0, 1] = 0
    present[0, 1, 31] = 1
    present[1] = 0
    return af, present, ib


WALK_ROWS = {"random": lambda: random_words(5), "random_b": lambda: random_words(6), "edges": edge_words}
