"""The one-launch Huffman table build (`csrc/huffman_kernels.cu`) on the CPU.

The kernel itself runs only on a card (`tests/test_torch_cuda.py`).  Here:
  * a numpy model of the kernel's algorithm, one (image, stream) at a time:
    slots reused by the merged node, symbols that carry their node's key,
    the clamp decided per stream, codes by length then symbol rank.  It
    equals the plain version, and both equal JAX's `build_tables_device`;
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

from _huffman_rows import _deep, _heavy, _random, _sparse, _zero

DEAD = np.iinfo(np.int64).max
SLOTS = max(C.ALPHABET_SIZES)  # 343: a block's slots, one a thread


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
    "heavy": _heavy(9), "make_image": _make_image_counts(),
}


def _merge(c: np.ndarray) -> np.ndarray:
    """The kernel's merge of one stream: (n,) counts -> (n,) code lengths.

    SLOTS slots, those past the alphabet dead; each step takes the two least
    keys, writes the merged node into the first one's slot and kills the
    other; a symbol whose node key is one of the two gains a bit and takes
    the merged key.  Every test reads the old keys, as each thread does."""
    n = len(c)
    slot = np.full(SLOTS, DEAD, np.int64)
    slot[:n] = (c << 11) | np.arange(n)
    node = slot[:n].copy()
    length = np.ones(n, np.int64)
    for _ in range(n - 2):
        ka, kb = np.sort(slot)[:2]
        merged = (((ka >> 11) + (kb >> 11)) << 11) | 1024 | min(ka & 1023, kb & 1023)
        at_a, at_b = slot == ka, slot == kb
        assert at_a.sum() == 1 and at_b.sum() == 1, "keys are unique among live nodes"
        slot[at_a], slot[at_b] = merged, DEAD
        under = (node == ka) | (node == kb)
        length[under] += 1
        node[under] = merged
    return length


def model_stream(counts: np.ndarray):
    """One (image, stream) as one block runs it: (n,) counts -> (lengths,
    uint32 codes, overflow, whether the clamp re-merge ran)."""
    c = counts.astype(np.int64)
    length = _merge(c)
    clamped = bool((length > C.MAX_CODE_LEN).any())
    if clamped:
        length = _merge(np.maximum(c, (c.sum() >> 20) + 1))
    cnt = np.bincount(length, minlength=64)  # symbols of each length
    codes = np.zeros(len(c), np.uint32)
    for t, ln in enumerate(length):
        if 1 <= ln <= C.MAX_CODE_LEN + 1:
            first = sum(int(cnt[j]) << (ln - j) for j in range(1, ln))
            rank = int((length[:t] == ln).sum())
            codes[t] = (first + rank) & 0xFFFFFFFF
    return length.astype(np.int32), codes, bool((length > C.MAX_CODE_LEN).any()), clamped


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
    # the model re-merges exactly the streams whose plain merge passes 31
    # bits: the deep fixture's row 1, and streams with many empty symbols,
    # whose tied zero weights merge into one chain under the least symbol
    raw = thd._merge_lengths(thd._counts_to_streams(torch.from_numpy(counts)))
    np.testing.assert_array_equal(clamped, (raw > C.MAX_CODE_LEN).any(dim=-1).numpy())
    assert case != "deep" or clamped[1, C.SC_LUMA_BASE_DIFF]


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
