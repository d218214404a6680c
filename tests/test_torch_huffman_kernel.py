"""The one-launch Huffman table build (`csrc/huffman_kernels.cu`) on the CPU.

The kernel itself runs only on a card (`tests/test_torch_cuda.py`).  Here:
  * a numpy model of the kernel's schedule, one (image, stream) at a time:
    one warp a merge chain, lane l holding slots and symbols l, l + 32, ...;
    each lane's two least keys combined into the warp's two minima (int
    keys where the counts allow, else high then low words), checked against
    `np.sort` at every step; the clamped merge run beside the raw one and
    the selection between them; canonical codes by 32-symbol chunks.  It
    equals the plain version, and both equal JAX's `build_tables_device`;
  * that the rows reach what the schedule must get right: equal-weight
    internal nodes taken out of creation order, and streams whose clamped
    merge differs from the raw one although the raw one fits 31 bits;
  * the plain version against JAX on rows the older tests lack;
  * the wrapper on a CPU tensor: the plain version, no launch counted, and
    the inputs it refuses.

JAX runs on batches of 3, so that `build_tables_device` compiles once.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.kernels import huffman_dev as jhd
from nicetpu_torch.bench import make_image
from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels import cuda_ops, encode2
from nicetpu_torch.kernels import huffman_dev as thd

from _huffman_rows import _bounds, _deep, _heavy, _random, _sparse, _ties, _zero

LANES = 32
DEAD64 = np.iinfo(np.int64).max
DEAD31 = np.iinfo(np.int32).max
NARROW = 1 << 20  # counts and stream total below this: the key fits an int
MASK32 = 0xFFFFFFFF


def _make_image_counts():
    """Histograms of three seeded 64x64 `make_image` images, through the
    port's tokenizer and the histogram's plain version."""
    imgs = np.stack([make_image(64, 64, seed) for seed in (3, 4, 5)])
    flat = torch.from_numpy(imgs.reshape(3, -1, 3))
    _, stats = encode2.tokenize_compact(flat, width=64, ndigits_cap=3)
    assert not stats[:, -1].any()
    return stats[:, :-1].numpy().astype(np.int64)


CASES = {
    "random": _random(7), "sparse": _sparse(8), "deep": _deep(), "zero": _zero(),
    "heavy": _heavy(9), "make_image": _make_image_counts(), "ties": _ties(11), "bounds": _bounds(14),
}


def _warp_min(keys: np.ndarray, narrow: bool) -> int:
    """The least of the 32 lanes' keys as the warp reduces it: one int
    minimum, or the high words' minimum (sign bit flipped, so that unsigned
    order is int64 order) and then the low words' among the lanes that tie."""
    if narrow:
        assert (keys >= 0).all() and (keys <= DEAD31).all()
        return int(keys.min())
    hi = ((keys >> 32) & MASK32) ^ 0x80000000
    lo = keys & MASK32
    h = int(hi.min())
    low = int(np.where(hi == h, lo, MASK32).min())
    k = ((h ^ 0x80000000) << 32) | low
    return k - (1 << 64) if k >= 1 << 63 else k


def _lanes(values: np.ndarray, fill) -> np.ndarray:
    """(n,) -> (K, 32): entry [j, l] is symbol or slot 32 j + l."""
    k = -(-len(values) // LANES)
    out = np.full(k * LANES, fill, np.int64)
    out[: len(values)] = values
    return out.reshape(k, LANES)


def warp_merge(c: np.ndarray) -> np.ndarray:
    """One warp's merge of one stream: (n,) counts -> (n,) code lengths.

    Lane l holds slots and symbols l, l + 32, ...  A step: each lane's two
    least slot keys; the warp's least, then its least once the lane that
    held it offers its second; the merged node into the first one's slot,
    the other slot dead; a symbol whose node key is one of the two gains a
    bit and takes the merged key.  Every test reads the old keys.  With int
    keys the kernel tests "at most kb" for "ka or kb" and "at most ka" for
    "ka" (the sign of a difference): the model asserts that they agree."""
    n = len(c)
    counts = _lanes(c, 0)
    sym = np.arange(counts.size).reshape(counts.shape)
    live = sym < n
    narrow = bool((counts >= 0).all() and (counts < NARROW).all() and counts.sum() < NARROW)
    dead = DEAD31 if narrow else DEAD64
    slot = np.where(live, (counts << 11) | sym, dead)
    node = slot.copy()
    length = live.astype(np.int64)
    pad = np.full((1, LANES), dead, np.int64)
    for _ in range(n - 2):
        m1, m2 = np.sort(np.vstack([slot, pad]), axis=0)[:2]  # each lane's two least
        ka = _warp_min(m1, narrow)
        kb = _warp_min(np.where(m1 == ka, m2, m1), narrow)
        assert [ka, kb] == np.sort(slot, axis=None)[:2].tolist()
        merged = (((ka >> 11) + (kb >> 11)) << 11) | 1024 | min(ka & 1023, kb & 1023)
        assert merged < dead
        at_a, at_b = slot == ka, slot == kb
        assert at_a.sum() == 1 and at_b.sum() == 1, "keys are unique among live nodes"
        under = (node == ka) | (node == kb)
        if narrow:
            np.testing.assert_array_equal(slot <= ka, at_a)
            np.testing.assert_array_equal(slot <= kb, at_a | at_b)
            np.testing.assert_array_equal(node <= kb, under)
        slot = np.where(at_a, merged, np.where(at_b, dead, slot))
        length += under
        node = np.where(under, merged, node)
    return length.ravel()[:n]


def warp_codes(length: np.ndarray) -> np.ndarray:
    """Canonical codes of one stream, (length asc, symbol asc), as the
    selected warp assigns them: chunk j holds symbols 32 j .. 32 j + 31; a
    symbol's rank is the running count of its length plus the lower lanes
    of the chunk with the same length (`__match_any_sync`); the running
    counts end as the count of each length, and lane L - 1 sums length L's
    first code from them, all in uint32."""
    n = len(length)
    lens = _lanes(length, 0)
    coded = (lens >= 1) & (lens <= C.MAX_CODE_LEN + 1)
    run = np.zeros(C.MAX_CODE_LEN + 1, np.int64)  # symbols of each length 1..32 so far
    rank = np.zeros_like(lens)
    for j, row in enumerate(lens):
        lower_same = np.tril(row[:, None] == row[None, :], -1).sum(axis=1)
        rank[j] = np.where(coded[j], run[np.clip(row - 1, 0, C.MAX_CODE_LEN)] + lower_same, 0)
        np.add.at(run, row[coded[j]] - 1, 1)
    first = np.array([sum(int(run[j - 1]) << (ln - j) for j in range(1, ln)) & MASK32
                      for ln in range(1, C.MAX_CODE_LEN + 2)], np.int64)
    codes = np.where(coded, (first[np.clip(lens - 1, 0, C.MAX_CODE_LEN)] + rank) & MASK32, 0)
    return codes.ravel()[:n].astype(np.uint32)


def model_stream(counts: np.ndarray):
    """One (image, stream) as one block runs it: (n,) counts -> (lengths,
    uint32 codes, overflow, whether the clamped merge was selected).  Warp 0
    merges the counts, warp 1 at the same time the counts raised to
    max(c, (total >> 20) + 1); warp 1's lengths are taken only where warp
    0's pass 31 bits, as the plain version re-merges only those streams."""
    c = counts.astype(np.int64)
    raw = warp_merge(c)
    clamped = warp_merge(np.maximum(c, (c.sum() >> 20) + 1))
    selected = bool((raw > C.MAX_CODE_LEN).any())
    length = clamped if selected else raw
    return (length.astype(np.int32), warp_codes(length), bool((length > C.MAX_CODE_LEN).any()), selected)


def model_tables(counts: np.ndarray):
    """(B, 858) counts -> (lengths, uint32 codes, overflow (B,), clamped
    (B, 10)), stream by stream."""
    B = counts.shape[0]
    lengths = np.zeros((B, C.TOTAL_SYMBOLS), np.int32)
    codes = np.zeros((B, C.TOTAL_SYMBOLS), np.uint32)
    overflow = np.zeros(B, bool)
    clamped = np.zeros((B, C.NUM_STREAMS), bool)
    for b in range(B):
        for s, (base, size) in enumerate(zip(C.STREAM_BASE, C.ALPHABET_SIZES)):
            ln, cd, ovf, cl = model_stream(counts[b, base : base + size])
            lengths[b, base : base + size], codes[b, base : base + size] = ln, cd
            overflow[b] |= ovf
            clamped[b, s] = cl
    return lengths, codes, overflow, clamped


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_and_plain_equal_jax(case):
    counts = CASES[case]
    jl, jc, jo = jhd.build_tables_device(jnp.asarray(counts.astype(np.int32)))
    pl, pc, po = thd.build_tables_device_plain(torch.from_numpy(counts.astype(np.int32)))
    ml, mc, mo, clamped = model_tables(counts)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pc.numpy().view(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ml, pl.numpy())
    np.testing.assert_array_equal(mc, pc.numpy().view(np.uint32))
    np.testing.assert_array_equal(mo, po.numpy())
    # the model selects exactly the streams whose plain merge passes 31
    # bits: the deep fixture's row 1, and streams with many empty symbols,
    # whose tied zero weights merge into one chain under the least symbol
    raw = thd._merge_lengths(thd._counts_to_streams(torch.from_numpy(counts)))
    np.testing.assert_array_equal(clamped, (raw > C.MAX_CODE_LEN).any(dim=-1).numpy())
    assert case != "deep" or clamped[1, C.SC_LUMA_BASE_DIFF]


def test_wide_keys_equal_the_plain_version():
    """Counts past 2^20, so that the warps compare high and then low words:
    the random rows scaled up (totals near 2^40), int64 counts."""
    counts = _random(12) * (1 << 28) + _random(13)
    pl, pc, po = thd.build_tables_device_plain(torch.from_numpy(counts))
    ml, mc, mo, _ = model_tables(counts)
    np.testing.assert_array_equal(ml, pl.numpy())
    np.testing.assert_array_equal(mc, pc.numpy().view(np.uint32))
    np.testing.assert_array_equal(mo, po.numpy())


def _taken_out_of_creation_order(c: np.ndarray) -> bool:
    """Whether the plain merge of one stream ever takes an internal node
    while an internal node of the same weight, made at an earlier step,
    stays live."""
    keys = {p: (int(w) << 11) | p for p, w in enumerate(c)}
    made = {}  # key of each live internal node -> the step that made it
    for it in range(len(c) - 2):
        ka, kb = sorted(keys.values())[:2]
        for k in (ka, kb):
            if k in made and any(m < made[k] and (o >> 11) == (k >> 11) and o not in (ka, kb)
                                 for o, m in made.items()):
                return True
        merged = (((ka >> 11) + (kb >> 11)) << 11) | 1024 | min(ka & 1023, kb & 1023)
        at = {v: p for p, v in keys.items()}
        keys[at[ka]] = merged
        del keys[at[kb]]
        made.pop(ka, None)
        made.pop(kb, None)
        made[merged] = it
    return False


def test_ties_row_takes_internal_nodes_out_of_creation_order():
    rows = CASES["ties"]
    for r, s in zip(rows, (C.SC_LUMA_BACK_REF, C.SC_SMALL_DIFF, C.SC_BACK_REF)):
        base, size = C.STREAM_BASE[s], C.ALPHABET_SIZES[s]
        assert _taken_out_of_creation_order(r[base : base + size])


@pytest.mark.parametrize("case", ["deep", "heavy", "sparse", "zero"])
def test_rows_exercise_the_selection(case):
    """Some stream fits 31 bits in its raw merge but merges otherwise once
    clamped, so that taking the clamped warp's lengths there would be
    wrong: the kernel must select, not prefer, the clamped merge."""
    cs = thd._counts_to_streams(torch.from_numpy(CASES[case]))
    raw = thd._merge_lengths(cs)
    clamped = thd._merge_lengths(torch.maximum(cs, (cs.sum(dim=-1, keepdim=True) >> 20) + 1))
    fits = ~(raw > C.MAX_CODE_LEN).any(dim=-1)
    assert int((fits & (raw != clamped).any(dim=-1)).sum()) > 0


def test_wrapper_on_the_cpu_runs_the_plain_version():
    counts = torch.from_numpy(_deep())
    before = dict(cuda_ops.LAUNCHES)
    got32 = thd.build_tables_device(counts.to(torch.int32))
    got64 = thd.build_tables_device(counts)
    want = thd.build_tables_device_plain(counts)
    assert cuda_ops.LAUNCHES == before
    for got in (got32, got64):
        assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.bool]
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("bad", [
    torch.zeros(2, C.TOTAL_SYMBOLS, dtype=torch.float32),
    torch.zeros(2, C.TOTAL_SYMBOLS, dtype=torch.int16),
    torch.zeros(2, C.TOTAL_SYMBOLS - 1, dtype=torch.int32),
    torch.zeros(C.TOTAL_SYMBOLS, dtype=torch.int32),
    torch.zeros(0, C.TOTAL_SYMBOLS, dtype=torch.int32),
    np.zeros((2, C.TOTAL_SYMBOLS), np.int32),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        thd.build_tables_device(bad)
