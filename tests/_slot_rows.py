"""Walk records for the slot assembly's tests: random ones and adversarial
ones, as numpy (B, nch, steps) int32 pos, sym, i12, i34, wbits (B,) and
n_pixels.  Imports numpy only, so the CPU tests, the card tests and
`chip_smoke.py` share them."""

import numpy as np

RUN_BASE = 5  # C.PREFIX_RUN_BASE: symbols 0..4 are prefixes, 5..12 run digits
MAX_RUN_DIGITS = 11  # C.MAX_RUN_DIGITS


def _walk_like(rng, B, nch, steps, p_digit=0.3):
    """Records as the walk writes them: each chunk's steps live up to a
    random point, then pos -1 and zeros; prefixes and run digits mixed."""
    pos = np.full((B, nch, steps), -1, np.int64)
    sym = np.zeros((B, nch, steps), np.int64)
    i12 = rng.integers(0, 2**31, (B, nch, steps))
    i34 = rng.integers(0, 2**31, (B, nch, steps))
    wbits = np.zeros(B, np.int64)
    for b in range(B):
        bits = 0
        for c in range(nch):
            n = int(rng.integers(steps // 2, steps + 1))
            pos[b, c, :n] = bits + np.arange(n) * 3
            digit = rng.random(n) < p_digit
            sym[b, c, :n] = np.where(digit, rng.integers(RUN_BASE, RUN_BASE + 8, n), rng.integers(0, RUN_BASE, n))
            bits += 3 * n
        wbits[b] = bits
    i12[pos < 0] = 0
    i34[pos < 0] = 0
    return pos, sym, i12, i34, wbits


def _chains(rng, B, nch, steps):
    """Long digit chains across chunk boundaries: chunks of digits only
    between prefixes, chains past 11 digits, the 11th digit above 1, digits
    before any prefix."""
    n = nch * steps
    sym = np.full((B, n), RUN_BASE + 7, np.int64)
    for b in range(B):
        at = int(rng.integers(1, 3 * steps))  # digits before the first prefix
        while at < n:
            sym[b, at] = rng.integers(0, RUN_BASE)
            at += int(rng.integers(1, 2 * steps + 40))
    sym[:, :: 7] = np.where(sym[:, :: 7] >= RUN_BASE, RUN_BASE + 1, sym[:, :: 7])
    pos = np.broadcast_to(np.arange(n), (B, n)).copy()
    wbits = np.full(B, n, np.int64)
    return (pos.reshape(B, nch, steps), sym.reshape(B, nch, steps),
            *(rng.integers(-(2**31), 2**31, (B, nch, steps)) for _ in range(2)), wbits)


def _noise(rng, B, nch, steps):
    """Any int32 values: negative and huge symbols, positions past wbits and
    below 0 anywhere."""
    shape = (B, nch, steps)
    pos = rng.integers(-3, 2**20, shape)
    sym = rng.integers(-3, 13, shape)
    big = rng.random(shape) < 0.02
    sym[big] = rng.integers(2**30, 2**31, int(big.sum()))
    wbits = rng.integers(0, 2**20, B)
    return pos, sym, *(rng.integers(-(2**31), 2**31, shape) for _ in range(2)), wbits


def records(case: str, B: int, nch: int, steps: int, seed: int = 0):
    """(pos, sym, i12, i34 (B, nch, steps) int32, wbits (B,) int32, n_pixels)."""
    rng = np.random.default_rng(seed)
    if case == "walk":
        pos, sym, i12, i34, wbits = _walk_like(rng, B, nch, steps)
        N = int(0.9 * (pos >= 0).sum(axis=(1, 2)).min() * 2)
    elif case == "chains":
        pos, sym, i12, i34, wbits = _chains(rng, B, nch, steps)
        N = nch * steps * 4
    elif case == "noise":
        pos, sym, i12, i34, wbits = _noise(rng, B, nch, steps)
        N = nch * steps
    elif case == "past_n":  # coverage reaches N inside a chunk early on: few real slots
        pos, sym, i12, i34, wbits = _walk_like(rng, B, nch, steps, p_digit=0.6)
        N = steps + 37
    elif case == "unequal":  # one image with no real slot (nothing valid), the others cut short
        pos, sym, i12, i34, wbits = _walk_like(rng, B, nch, steps)
        wbits = (wbits * rng.uniform(0.2, 0.9, B)).astype(np.int64)
        wbits[0] = 0
        N = 10**9
    elif case == "no_prefix":  # digits only: no real slot anywhere, K = 1
        pos, sym, i12, i34, wbits = _walk_like(rng, B, nch, steps, p_digit=1.0)
        N = 1000
    else:
        raise ValueError(case)
    cast = [np.ascontiguousarray(a).astype(np.int32) for a in (pos, sym, i12, i34, wbits)]
    return (*cast, max(1, N))


CASES = ("walk", "chains", "noise", "past_n", "unequal", "no_prefix")
