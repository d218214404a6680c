"""A CPU model of the fold kernel's schedule.

`fold_records_kernel` (nicetpu_torch/csrc/encode_kernels.cu) does not keep
a group's ten record words in registers as the Pallas kernel does.  A slot
at bit offset `cum` only touches words `cum >> 5` and the next, and `cum`
never falls, so a thread keeps those two words (`w0`, `w1`) and, when
`cum >> 5` moves on, emits the finished word into its column of a record
tile; words at index 10 and beyond are dropped, words never reached are
zero.  The slots arrive in tiles of 16; a last, shorter tile is walked slot
by slot.  The window holds for lengths 0..32; a group holding any other
length (the largest, read as unsigned, is then over 32) is folded
again by the generic ten-word fold.

`_window_fold` below follows that schedule in numpy, group by group in
lockstep, with the kernel's `slot_words` expressions.  It is held exactly
against `cuda_ops.fold_records_plain` and against the Pallas kernel in
interpret mode: codes masked to their lengths and codes of any 32-bit
pattern (also under zero lengths), S in {13, 16, 64, 128}, groups over 320
bits, lengths of 32, all-hole groups, and lengths outside 0..32.  Integer
arithmetic: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.kernels.pallas_ops import fold_records_pallas
from nicetpu_torch.kernels import cuda_ops

from test_torch_kernels import _rand_fold

CAPW = cuda_ops.FOLD_CAPW
TILE = 16  # kFoldTile
U32 = 0xFFFFFFFF


def _slot_words(sb, L, cd):
    """The kernel's slot_words on int64 arrays (cd holds uint32 values)."""
    fits = sb + L <= 32
    k = np.where(fits, 0, sb + L - 32)
    sh_hi = np.clip(np.where(fits, 32 - sb - L, k), 0, 31)
    hi = np.where(fits, (cd << sh_hi) & U32, cd >> sh_hi)
    mask = np.where(k >= 32, U32, (1 << np.minimum(k, 32)) - 1)
    sh_lo = np.clip(32 - k, 0, 31)
    lo = np.where(fits, 0, ((cd & mask) << sh_lo) & U32)
    return hi, lo


def _window_fold(aob, code):
    """(B, Mg, S) int32 lengths and code bit patterns -> (rec (B, CAPW, Mg)
    int32 bit patterns, k (B, Mg) int32, redone (B, Mg) bool), by the
    kernel's schedule."""
    B, Mg, S = aob.shape
    G = B * Mg
    Ls = aob.reshape(G, S).astype(np.int64)
    cds = code.reshape(G, S).view(np.uint32).astype(np.int64)
    col = np.full((G, CAPW), 0xDEADBEEF, np.int64)  # the tile starts as garbage
    w0, w1 = np.zeros(G, np.int64), np.zeros(G, np.int64)
    cum, cur = np.zeros(G, np.int64), np.zeros(G, np.int64)
    seen = np.zeros(G, np.int64)
    rows = np.arange(G)
    for p in range(-(-S // TILE)):  # tile by tile, as the kernel stages them
        for s in range(p * TILE, min(S, (p + 1) * TILE)):
            L, cd = Ls[:, s], cds[:, s]
            sw = cum >> 5
            hi, lo = _slot_words(cum & 31, L, cd)
            move = sw != cur
            emit = move & (cur >= 0) & (cur < CAPW)
            col[rows[emit], cur[emit]] = w0[emit]
            w0 = np.where(move, w1, w0) | hi
            w1 = np.where(move, 0, w1) | lo
            cur = np.where(move, sw, cur)
            cum = cum + L
            seen = np.maximum(seen, L & U32)
    redo = seen > 32
    rec = np.zeros((G, CAPW), np.int64)
    for j in range(CAPW):
        rec[:, j] = np.where(j < cur, col[:, j], np.where(j == cur, w0, np.where(j == cur + 1, w1, 0)))
    k = cum.astype(np.int32)  # wraps as the kernel's int32 sum
    if redo.any():  # the generic fold of those groups
        a = torch.from_numpy(aob.reshape(1, G, S)[:, redo])
        c = torch.from_numpy(code.reshape(1, G, S)[:, redo])
        r2, k2 = cuda_ops.fold_records_plain(a, c)
        rec[redo] = r2[0].numpy().view(np.uint32).astype(np.int64).T
        k[redo] = k2[0].numpy()
    rec = rec.astype(np.uint32).view(np.int32).reshape(B, Mg, CAPW).transpose(0, 2, 1)
    return rec, k.reshape(B, Mg), redo.reshape(B, Mg)


def _check_against_plain(aob, code, redone=False):
    rec, k, redo = _window_fold(aob, code)
    want_rec, want_k = cuda_ops.fold_records_plain(torch.from_numpy(aob), torch.from_numpy(code))
    np.testing.assert_array_equal(k, want_k.numpy())
    np.testing.assert_array_equal(rec, want_rec.numpy())
    assert bool(redo.any()) == redone
    return k


@pytest.mark.parametrize("S", [13, 16, 64, 128])
@pytest.mark.parametrize("full_codes", [False, True], ids=["masked", "any32"])
def test_window_fold_equals_plain(S, full_codes):
    """Random slots; with S >= 64 most groups run over 320 bits, so words
    at index 10 and beyond are dropped; any32 also puts codes under zero
    lengths."""
    aob, code = _rand_fold(2, 96, S, seed=S, full_codes=full_codes)
    k = _check_against_plain(aob, code)
    assert (k.max() > 32 * CAPW) == (S >= 64)


@pytest.mark.parametrize("S", [13, 16, 64])
def test_window_fold_equals_pallas_interpret(S):
    aob, code = _rand_fold(2, 64, S, seed=20 + S)
    rec, k, _ = _window_fold(aob, code)
    rec_w, k_w = fold_records_pallas(jnp.asarray(aob), jnp.asarray(code), capw=CAPW, interpret=True)
    np.testing.assert_array_equal(k, np.asarray(k_w)[:, :64])
    np.testing.assert_array_equal(rec, np.asarray(rec_w)[:, :, :64])


def test_lengths_of_32_and_every_bit_offset():
    """Every (bit offset, length) pair with lengths up to 32: a first slot
    of 0..31 bits sets the offset, the second has 0..32."""
    sb, L = np.meshgrid(np.arange(32), np.arange(33), indexing="ij")
    rng = np.random.default_rng(3)
    aob = np.zeros((1, sb.size, 16), np.int32)
    aob[0, :, 0], aob[0, :, 1] = sb.ravel(), L.ravel()
    aob[0, :, 2:] = rng.integers(0, 33, (sb.size, 14))
    code = rng.integers(0, 2**32, aob.shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    _check_against_plain(aob, code)


def test_full_words_in_a_row():
    """64 slots of 32 bits: the window moves on at every slot and all but
    ten words are dropped."""
    rng = np.random.default_rng(4)
    aob = np.full((1, 8, 64), 32, np.int32)
    code = rng.integers(0, 2**32, aob.shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    k = _check_against_plain(aob, code)
    assert (k == 2048).all()


@pytest.mark.parametrize("code_value", [0, -1], ids=["zero_codes", "set_codes"])
def test_all_hole_groups(code_value):
    """Zero lengths throughout: k is 0; a code under a zero length still
    lands where the generic fold puts it."""
    aob = np.zeros((2, 5, 64), np.int32)
    code = np.full(aob.shape, code_value, np.int32)
    k = _check_against_plain(aob, code)
    assert (k == 0).all()


@pytest.mark.parametrize("bad", [33, 100, -1, -40, 2**20, -(2**20)])
def test_lengths_outside_the_window_take_the_generic_fold(bad):
    """One length outside 0..32 in some groups: those groups are folded
    again by the generic fold, the others keep the window's result."""
    aob, code = _rand_fold(1, 40, 64, seed=7, full_codes=True)
    aob[0, ::3, 5] = bad
    rec, k, redo = _window_fold(aob, code)
    assert redo[0, ::3].all() and not redo[0, 1::3].any() and not redo[0, 2::3].any()
    _check_against_plain(aob, code, redone=True)
