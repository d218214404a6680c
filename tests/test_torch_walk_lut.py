"""A CPU model of the walk kernel's decode tables.

`walk_kernel` (nicetpu_torch/csrc/decode_kernels.cu) builds, in its
prologue, shared-memory tables from the image's aff/dD/inc: `thr`, the
running maximum of aff over lengths 1..l (its count up to the stream's cap
is the threshold count before the first miss), `cinc` and `cdD`, the running
sums of inc and dD; and from them a first-level decode table, indexed by
stream and the window's top K bits.  An entry is exact where the lowest and
the highest window of its prefix give the same count, the length is at most
K bits and the index is below 2**26; the kernel decodes its codes with one
lookup, and every other code with a binary search over `thr`.

`_tables`, `_lut` and `_slow` below do the same in torch.  Every exact
entry is held against `decode3._canon_decode` at the lowest, the highest
and random windows of its prefix, for every stream, and a walk that decodes
as the kernel does (table, else the search) is held against `walk_plain`,
on the golden files' tables, on random int32 tables (the wrapping sums) and
on the deep-code fixture (codes up to 31 bits).  Integer arithmetic: every
comparison is exact.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nicetpu_torch.convert import MASK32
from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels import decode3 as td3

from test_torch_decode import _deep_stream

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = ["random8x6", "gradient16x12", "flat9x7", "mixed20x14"]
K, IDX_BITS = 10, 26  # the kernel's kLutBits, kLutIdxBits
CAPS = torch.tensor([td3._deep_cap(s) for s in range(C.NUM_STREAMS)])


def _tables(aff, dD, inc):
    """The kernel's (thr, cinc, cdD): thr (B, 10, 31) over lengths 1..31,
    +inf past each stream's cap; cinc, cdD (B, 10, 32), index n the sum over
    lengths 1..n (cdD wraps as uint32)."""
    thr = torch.cummax(aff[..., 1:].to(torch.int64), dim=-1).values
    thr = torch.where(torch.arange(1, 32) > CAPS[:, None], 2**40, thr).contiguous()

    def sums(t):
        return F.pad(torch.cumsum(t[..., 1:].to(torch.int64), dim=-1), (1, 0))

    return thr, sums(inc), sums(dD) & MASK32


def _first_miss(thr, win_b):
    """(B, 10, X) biased windows -> the thresholds at most each (a count)."""
    return torch.searchsorted(thr, win_b.contiguous(), right=True)


def _lut(aff, dD, inc):
    """The kernel's first-level table, (B, 10, 2**K): L << 26 | idx where
    exact, else -1."""
    thr, cinc, cdD = _tables(aff, dD, inc)
    B = aff.shape[0]
    lo = (torch.arange(1 << K, dtype=torch.int64) << (32 - K)).expand(B, C.NUM_STREAMS, -1)
    n = _first_miss(thr, lo - 2**31)
    same = _first_miss(thr, lo - 2**31 + (1 << (32 - K)) - 1) == n
    L = cinc.gather(-1, n)
    idx = (cdD.gather(-1, n) + (lo >> (32 - L.clamp(min=1)))) & MASK32
    exact = same & (L.clamp(min=1) <= K) & (idx < 1 << IDX_BITS)
    return torch.where(exact, (L << IDX_BITS) | idx, -1)


def _kernel_canon(aff, dD, inc):
    """`_canon_decode` as the kernel runs it: the table's exact entry, else
    the binary search over thr and the running sums."""
    lut = _lut(aff, dD, inc)
    thr, cinc, cdD = _tables(aff, dD, inc)

    def canon(win, tabs, s):
        n = _first_miss(thr[:, s], win - 2**31)
        L = cinc[:, s].gather(1, n)
        idx = (cdD[:, s].gather(1, n) + (win >> (32 - L.clamp(min=1)))) & MASK32
        idx = torch.where(idx >= 2**31, idx - 2**32, idx)
        e = lut[:, s].gather(1, win >> (32 - K))
        exact = e >= 0
        return torch.where(exact, e >> IDX_BITS, L), torch.where(exact, e & ((1 << IDX_BITS) - 1), idx)

    return canon


def _golden(name):
    """(words, wbits, pfx, aff, dD, inc) of one golden `.nice` file."""
    with open(os.path.join(DATA, f"{name}.nice"), "rb") as f:
        data = f.read()
    (words, wbits, af, pr, ib, pfx, _), _ = td3.prepare_batch_args([data], device="cpu")
    return (words, wbits, pfx, *td3.derive_walk_tables(af, pr, ib))


def _random(seed=5):
    """Arbitrary int32 tables (as test_torch_decode feeds derive_walk_tables)
    over the words of a golden file."""
    words, wbits, pfx, *_ = _golden("mixed20x14")
    rng = np.random.default_rng(seed)
    raf = rng.integers(-(2**31), 2**31, (1, 10, 32)).astype(np.int32)
    rpr = (rng.random((1, 10, 32)) < 0.4).astype(np.int32)
    rpr[0, 4] = 0  # a stream with no length present
    rib = rng.integers(-(2**31), 2**31, (1, 10, 32)).astype(np.int32)
    tables = td3.derive_walk_tables(*(torch.from_numpy(a) for a in (raf, rpr, rib)))
    return (words, wbits, pfx, *tables)


def _deep():
    lengths, words, wbits = _deep_stream()
    af, pr, ib, pfx, *_ = td3.prepare_tables_v3(torch.from_numpy(lengths[None]))
    w = torch.from_numpy(words.view(np.int32)[None].copy())
    return (w, torch.tensor([wbits], dtype=torch.int32), pfx, *td3.derive_walk_tables(af, pr, ib))


CASES = {**{n: (lambda n=n: _golden(n)) for n in GOLDEN}, "random": _random, "deep": _deep}


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_entries_match_canon_decode(case):
    *_, aff, dD, inc = CASES[case]()
    lut = _lut(aff, dD, inc)
    B = aff.shape[0]
    assert lut.shape == (B, C.NUM_STREAMS, 1 << K)
    tabs = td3._stream_tables(aff, dD, inc)
    rng = np.random.default_rng(0)
    lo = torch.arange(1 << K, dtype=torch.int64) << (32 - K)
    span = 1 << (32 - K)
    wins = [lo, lo + span - 1] + [lo + torch.from_numpy(rng.integers(0, span, 1 << K)) for _ in range(3)]
    for s in range(C.NUM_STREAMS):
        e = lut[:, s]
        exact = e >= 0
        for win in wins:
            L, idx = td3._canon_decode(win.expand(B, -1), tabs, s)
            assert torch.equal(torch.where(exact, e >> IDX_BITS, 0), torch.where(exact, L, 0))
            assert torch.equal(torch.where(exact, e & ((1 << IDX_BITS) - 1), 0),
                               torch.where(exact, idx, 0))
    if case != "random":  # real tables: the table decodes most codes
        assert bool((lut[:, C.SC_PREFIXES] >= 0).float().mean() > 0.9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_through_the_table_matches_walk_plain(case, monkeypatch):
    words, wbits, pfx, aff, dD, inc = CASES[case]()
    chunk_bits = 512
    steps = td3._steps(chunk_bits, 8)
    nch = -(-int(wbits.max()) // chunk_bits)
    e = (torch.arange(nch, dtype=torch.int32) * chunk_bits)[None].expand(words.shape[0], nch)
    kw = dict(chunk_bits=chunk_bits, steps=steps)
    want, got = [], []
    for _ in range(2):  # round 1 from the chunk starts, round 2 from its exits
        want.append(td3.walk_plain(words, e, aff, dD, inc, pfx, wbits, **kw))
        e = torch.cat([torch.zeros_like(e[:, :1]), want[-1][4][:, :-1]], dim=1)
    monkeypatch.setattr(td3, "_canon_decode", _kernel_canon(aff, dD, inc))
    e = (torch.arange(nch, dtype=torch.int32) * chunk_bits)[None].expand(words.shape[0], nch)
    for _ in range(2):
        got.append(td3.walk_plain(words, e, aff, dD, inc, pfx, wbits, **kw))
        e = torch.cat([torch.zeros_like(e[:, :1]), got[-1][4][:, :-1]], dim=1)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
