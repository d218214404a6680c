"""The tokenizer kernel's design and its wrapper on the CPU.

`csrc/tokenize_kernels.cu` runs one launch a call.  Blocks take spans of
pixels by an atomic ticket, an image's last span first; each publishes its
first change (or "none"), looks ahead over the later spans' published words
for the next change after its end, and finds each pixel's next change from
warp ballots and a suffix minimum over its mask words, ended by the tail
(the later shards' first changes).  It stages the pixels its probes read in
four row segments (or one window where W is small) as packed 32-bit words
and runs the cascade on packed lanes.  Modelled here in numpy: the schedule
under random ticket interleavings at spans and warps small enough to cut
every boundary, held against `suffix_min`; the staging, held against every
probe offset of the format; and the whole kernel (staging, schedule,
cascade on packed lanes, slots) held against `tokenize_bins_plain`.
`tokenize.tokenize_bins`, which runs its plain version on a CPU tensor, is
held against JAX's `cascade` + `assemble_bins` with a halo and against
`jax.vmap(_tokenize_core)`.  Every comparison is bit-exact.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.kernels import encode2 as jenc
from nicetpu.kernels import tokenize as jtok
from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels import cuda_ops
from nicetpu_torch.kernels import tokenize as ttok
from nicetpu_torch.kernels.scan import suffix_min


# ---------------------------------------------------------------------------
# the schedule: tickets, published words, the look-ahead, the ballots
# ---------------------------------------------------------------------------

NO_CHANGE = 0xFFFFFFFF  # a published word: no change in the span, the next one not yet known


def _first(bits):
    """Index of the lowest set bit, or None."""
    return (bits & -bits).bit_length() - 1 if bits else None


def _block(ticket, spans, changed, g0, n_total, tail, words, started, *, span, warp):
    """One block of the kernel as a generator that yields where another
    block may run.  Writes its pixels' next changes into `out`, returned."""
    n = changed.shape[1]
    b, j = ticket // spans, spans - 1 - ticket % spans
    s, e = j * span, min((j + 1) * span, n)
    base = g0 + s
    yield
    # the change mask, one word of `warp` bits a warp
    mask = [sum(1 << l for l in range(warp) if s + w * warp + l < e and changed[b, s + w * warp + l])
            for w in range(span // warp)]
    firsts = [base + w * warp + _first(m) if m else None for w, m in enumerate(mask)]
    own = min((f for f in firsts if f is not None), default=None)
    words[b][j] = own + 1 if own is not None else NO_CHANGE
    yield
    # the look-ahead: `warp` lanes read the later spans' words
    q0 = j + 1
    while True:
        window = []
        for lane in range(warp):
            q = q0 + lane
            if q < spans:
                assert started[b * spans + (spans - 1 - q)], "a block waits on a span no block has taken"
                window.append(words[b][q])
            else:
                window.append(n_total + 1)
        known = sum(1 << l for l, w in enumerate(window) if w not in (0, NO_CHANGE))
        ready = sum(1 << l for l, w in enumerate(window) if w != 0)
        if known:
            at = _first(known)
            if ready & ((1 << at) - 1) == (1 << at) - 1:
                nxt = window[at] - 1
                break
        elif ready == (1 << warp) - 1:
            q0 += warp
            continue
        yield  # spin
    if own is None:
        words[b][j] = nxt + 1
    yield
    t = min(tail, default=2**31 - 1)
    # the suffix over the mask words, then each pixel's ballot
    word_next = [min([f for f in firsts[w + 1:] if f is not None] + [nxt, t]) for w in range(len(mask))]
    out = {}
    for p in range(e - s):
        w, lane = divmod(p, warp)
        later = mask[w] & ~((2 << lane) - 1)
        out[s + p] = min(base + p - lane + _first(later), t) if later else word_next[w]
    return b, out


def _model_next(changed, g0, n_total, tail, *, span, warp, resident, seed):
    """Every pixel's next change as the kernel finds it, blocks taking
    tickets in order and run in a random interleaving, at most `resident`
    at a time."""
    B, n = changed.shape
    spans = -(-n // span)
    rng = np.random.default_rng(seed)
    words = [[0] * spans for _ in range(B)]
    started = [False] * (B * spans)
    out = np.full((B, n), -1, dtype=np.int64)
    running, ticket, steps = [], 0, 0
    while ticket < B * spans or running:
        if ticket < B * spans and len(running) < resident and (not running or rng.random() < 0.5):
            started[ticket] = True
            gen = _block(ticket, spans, changed, g0, n_total, tail, words, started, span=span, warp=warp)
            running.append(gen)
            ticket += 1
            continue
        gen = running[rng.integers(len(running))]
        try:
            next(gen)
        except StopIteration as done:
            b, nxt = done.value
            for i, v in nxt.items():
                out[b, i] = v
            running.remove(gen)
        steps += 1
        assert steps < 10_000 * B * spans, "no forward progress"
    return torch.from_numpy(out)


def _reference_next(changed, g0, n_total, tail):
    pos = torch.arange(changed.shape[1], dtype=torch.int64) + g0
    sfx = suffix_min(torch.where(changed, pos, n_total))
    nxt = torch.cat([sfx[:, 1:], torch.full((changed.shape[0], 1), n_total, dtype=torch.int64)], dim=1)
    return torch.minimum(nxt, torch.tensor(min([n_total, *tail]), dtype=torch.int64))


def _changes(name, n, span):
    rng = np.random.default_rng(n)
    c = np.zeros((3, n), bool)
    if name == "all_run":
        c[:, 0] = True  # pixel 0 only: one run to the end
    elif name == "last_pixel":
        c[:, 0] = True
        c[:, -1] = True
    elif name == "span_edges":  # changes at span starts, at span ends, in every other span
        c[0, ::span] = True
        c[1, span - 1 :: span] = True
        for j in range(0, n, 2 * span):
            c[2, j : j + span : 3] = True
    elif name == "sparse":
        c = rng.random((3, n)) < 0.02
    elif name == "none":  # a shard with no change at all
        pass
    return torch.from_numpy(c)


RUN_CASES = ["all_run", "last_pixel", "span_edges", "sparse", "none"]
# (span, warp, resident blocks, interleaving seed): small ones cut every
# boundary; one resident block runs the tickets strictly in order
SCHEMES = [(8, 4, 3, 0), (16, 4, 1, 1), (32, 8, 6, 2), (cuda_ops.TOKENIZE_SPAN, 32, 4, 3)]


@pytest.mark.parametrize("span,warp,resident,seed", SCHEMES)
@pytest.mark.parametrize("case", RUN_CASES)
def test_span_schedule_matches_suffix_min(case, span, warp, resident, seed):
    n = 5 * span + 3  # a ragged last span
    changed = _changes(case, n, span)
    for g0, n_total, tail in ((0, n, []), (2 * n, 4 * n, [3 * n + 5, 3 * n + 1]), (n, 2 * n, [])):
        got = _model_next(changed, g0, n_total, tail, span=span, warp=warp, resident=resident, seed=seed)
        np.testing.assert_array_equal(got.numpy(), _reference_next(changed, g0, n_total, tail).numpy())


def _halo_raster(H, W, seed):
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 4, (H, W, 3)) * 60).astype(np.uint8)
    img[H // 3 : H // 2] = img[H // 3, 0]  # a run over rows
    return img.reshape(-1, 3)


@pytest.mark.parametrize("W", [4, 7, 300])
def test_first_change_plain_matches_the_changed_positions(W):
    """What a shard all-gathers, from real rasters, with and without a halo,
    and from a shard that is one run."""
    flat = np.stack([_halo_raster(24, W, s) for s in (1, 2)])
    flat[1, 12 * W - 1 :] = flat[1, 12 * W - 1]  # image 1: no change from g0 = 12 W on
    halo = ttok.halo_pixels(W)
    N = flat.shape[1]
    for g0 in (0, 8 * W, 12 * W):
        x_ext = torch.from_numpy(np.ascontiguousarray(flat[:, max(g0 - halo, 0) :]))
        h = min(g0, halo)
        got = ttok.first_change(x_ext, halo=h, g0=g0, n_total=N)
        want = []
        for b in range(2):
            x = flat[b].astype(np.int32)
            idx = [i for i in range(g0, N) if i == 0 or (x[i] != x[i - 1]).any()]
            want.append(idx[0] if idx else N)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (g0 != 12 * W) or int(got[1]) == N


# ---------------------------------------------------------------------------
# the staging: four row segments or one window, packed pixels
# ---------------------------------------------------------------------------

SPAN = cuda_ops.TOKENIZE_SPAN
SEG_PITCH = SPAN + 12  # kSegPitch: up to SPAN + 6 pixels and 3 of alignment
STAGE = 4 * SEG_PITCH  # kStage
UNSTAGED = 0xDEADBEEF  # no staged pixel reads as this


def _lanes(g, r, b):
    return np.uint32(g) | np.uint32(r) << np.uint32(11) | np.uint32(b) << np.uint32(22)


def _pack(px):
    """(..., 3) uint8 -> uint32 packed pixels: g in bits 0-10, r 11-21, b 22-31."""
    px = px.astype(np.uint32)
    return px[..., 1] | px[..., 0] << np.uint32(11) | px[..., 2] << np.uint32(22)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of y:x."""
    both = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(x), np.uint64)
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * k)) & np.uint64(255)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _rgb_lanes(w):
    w = np.asarray(w, np.uint32)
    return _lanes((w >> np.uint32(8)) & np.uint32(255), w & np.uint32(255), (w >> np.uint32(16)) & np.uint32(255))


def _stage_range(st, at, xb, img0, k0, length):
    """The kernel's `stage_range` on the word path: groups of four flat
    pixels from three little-endian words of the batch's bytes xb, unpacked
    by byte permutes; zeros before the image (k < 0) and past the batch."""
    total = xb.size // 3
    f_lo, f_hi = img0 + k0, img0 + k0 + length
    g = np.arange(f_lo >> 2, -(-f_hi // 4))
    f = 4 * g
    inside = (f >= 0) & (f + 4 <= total)
    w = np.zeros((g.size, 3), np.uint32)
    idx = np.clip(12 * g[inside, None] + np.arange(12), 0, xb.size - 1)
    w[inside] = xb[idx].reshape(-1, 3, 4).astype(np.uint32) @ (np.uint32(1) << np.arange(0, 32, 8, dtype=np.uint32))
    w0, w1, w2 = w.T
    q = np.stack([_rgb_lanes(w0), _rgb_lanes(_byte_perm(w0, w1, 0x0543)), _rgb_lanes(_byte_perm(w1, w2, 0x0432)),
                  _rgb_lanes(w2 >> np.uint32(8))], axis=1)
    for i in range(4):  # the groups at the batch's ends, pixel by pixel
        fi = f[~inside] + i
        ok = (fi >= 0) & (fi < total)
        q[~inside, i] = np.where(ok, _pack(xb.reshape(-1, 3)[np.clip(fi, 0, total - 1)]), 0)
    fi = f[:, None] + np.arange(4)
    q = np.where(fi < img0, 0, q)
    keep = (fi >= f_lo) & (fi < f_hi)
    assert at % 4 == f_lo % 4 and at + length <= STAGE
    st[at + (fi - f_lo)[keep]] = q[keep]


def _stage(xb, img0, ks, n, W):
    """The kernel's stage of one span: (stage words, bases d0, dW, d2W, d3W).
    xb: the batch's bytes, flat; img0: the image's first flat pixel; ks:
    the span's first index in the image."""

    def place(at0, k0):
        return at0 + ((img0 + k0 - at0) & 3)

    st = np.full(STAGE, UNSTAGED, dtype=np.uint32)
    if 3 * W + 6 + SPAN <= STAGE:
        at = place(0, ks - 3 * W - 3)
        _stage_range(st, at, xb, img0, ks - 3 * W - 3, n + 3 * W + 3)
        return st, (at + 3 * W, at + 2 * W, at + W + 3, at)
    ranges = [(0, ks - 3, n + 3), (SEG_PITCH, ks - W - 3, n + 6), (2 * SEG_PITCH, ks - 2 * W, n),
              (3 * SEG_PITCH, ks - 3 * W - 3, n + 6)]
    bases = tuple(place(at0, k0) for at0, k0, _ in ranges)
    for at, (_, k0, length) in zip(bases, ranges):
        _stage_range(st, at, xb, img0, k0, length)
    return st, bases


def _probes(W):
    """The kernel's reads: (offset back from the pixel, segment 0..3 for
    distance 0, W, 2W, 3W, index in the segment past the pixel's)."""
    return [(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 0, 0), (W, 1, 3), (W - 1, 1, 4), (W - 3, 1, 6), (W + 3, 1, 0),
            (2 * W, 2, 0), (3 * W - 3, 3, 6), (3 * W - 1, 3, 4), (3 * W, 3, 3), (3 * W + 1, 3, 2), (3 * W + 3, 3, 0)]


def _read(st, bases, W, off, p):
    seg, d = next((seg, d) for o, seg, d in _probes(W) if o == off)
    return st[bases[seg] + p + d]


def _staging_cases():
    return [(W, where) for W in (4, 5, 7, 300, 1100, 29051) for where in ("start", "middle", "end", "halo")]


@pytest.mark.parametrize("W,where", _staging_cases())
def test_staged_segments_hold_every_probe(W, where):
    """Every probe offset of the format lands in a staged segment, and the
    staged word is the packed pixel the cascade reads there: x_ext[k - off],
    zero before the halo-extended raster."""
    rng = np.random.default_rng(W)
    H = max(12, -(-4 * SPAN // W))
    N = H * W
    full = rng.integers(0, 256, (N, 3), dtype=np.uint8)
    g0 = 4 * W if where == "halo" else 0
    halo = min(g0, 4 * W)
    x_ext = full[g0 - halo :]
    n_local = N - g0
    spans = -(-n_local // SPAN)
    j = {"start": 0, "middle": spans // 2, "end": spans - 1, "halo": 0}[where]
    s = j * SPAN
    n = min(SPAN, n_local - s)
    # image 1 of a batch of 3 whose images are x_ext and two of another raster
    other = rng.integers(0, 256, x_ext.shape, dtype=np.uint8)
    xb = np.concatenate([other, x_ext, other]).reshape(-1)
    st, bases = _stage(xb, x_ext.shape[0], halo + s, n, W)
    offsets = set(C.back_ref_offsets(W)) | set(C.luma_ref_offsets(W)) | {0, 1, W}
    assert offsets <= {off for off, _, _ in _probes(W)}
    p = np.arange(n)
    k = halo + s + p
    for off, seg, d in _probes(W):
        got = st[bases[seg] + p + d]
        assert not (got == UNSTAGED).any(), f"offset {off} reads past its segment"
        want = np.where(k - off >= 0, _pack(x_ext[np.clip(k - off, 0, None)]), 0)
        np.testing.assert_array_equal(got, want, err_msg=f"offset {off}")
    assert (_read(st, bases, W, 1, p)[:1] == 0).all() == (g0 + s == 0)  # zeros before the raster


# ---------------------------------------------------------------------------
# the whole kernel: staging, schedule, the cascade on packed lanes, slots
# ---------------------------------------------------------------------------

BYTE_LANES = _lanes(255, 255, 255)
LUMA_BIAS, LUMA_SPREAD, LUMA_MISS = _lanes(288, 560, 48), _lanes(0, 1, 1), _lanes(0xC0, 0xE0, 0xE0)
SD_BIAS, RES_BIAS = _lanes(259, 259, 259), _lanes(256, 256, 256)
SB = C.STREAM_BASE


def _luma(cb, ref):
    x = (cb - ref).astype(np.uint32)
    return (x - (x & np.uint32(255)) * LUMA_SPREAD).astype(np.uint32)


def _cascade(st, bases, W, base, p, nxt, cap, invalid):
    """The kernel's `cascade` for the changed pixels p of the span that
    starts at global position base (numpy, uint32 lanes): (slots (len(p), 5
    + cap), overflow per pixel)."""
    pos = base + p
    edge = base < 3 * W + 3  # the position masks matter in this span

    def at(off):
        return pos >= off if edge else np.ones_like(pos, bool)

    def rd(off):
        return _read(st, bases, W, off, p)

    c, pv, u = rd(0), rd(1), rd(W)
    row0 = (pos < W) & edge
    first = pos > 0
    br = np.full(p.shape, -1)
    for q, off in reversed(list(enumerate(C.back_ref_offsets(W)))):
        br = np.where((c == rd(off)) & at(off), q, br)
    avg = ((u + pv) >> np.uint32(1)) & BYTE_LANES
    t = (c + SD_BIAS - np.where(row0, pv, avg)).astype(np.uint32)
    sg = (t & np.uint32(0x7FF)).astype(np.int64) - 256
    sr = ((t >> np.uint32(11)) & np.uint32(0x7FF)).astype(np.int64) - 256
    sb = (t >> np.uint32(22)).astype(np.int64) - 256
    sd = first & (sg >= 0) & (sg <= 6) & (sr >= 0) & (sr <= 6) & (sb >= 0) & (sb <= 6)
    cb = (c + LUMA_BIAS).astype(np.uint32)
    l2 = _luma(cb, avg)
    l2_hit = ~row0 & ((l2 & LUMA_MISS) == 0)
    li, lx = np.full(p.shape, -1), np.zeros(p.shape, np.uint32)
    for q, off in reversed(list(enumerate(C.luma_ref_offsets(W)))):
        d = _luma(cb, rd(off))
        hit = ((d & LUMA_MISS) == 0) & at(off)
        li, lx = np.where(hit, q, li), np.where(hit, d, lx)
    z = (c + RES_BIAS - np.where(row0, np.where(first, pv, 0), avg)).astype(np.uint32)
    mode = np.select([br >= 0, sd, l2_hit, li >= 0], [C.PREFIX_BACK_REF, C.PREFIX_SMALL_DIFF,
                     C.PREFIX_COLOR_LUMA2, C.PREFIX_COLOR_LUMA], C.PREFIX_RGB)

    def byte(v, lane):
        return ((v >> np.uint32(lane)) & np.uint32(255)).astype(np.int64)

    out = np.full((p.size, 5 + cap), invalid, dtype=np.int64)
    out[:, 0] = SB[C.SC_PREFIXES] + mode
    out[:, 1] = np.select(
        [br >= 0, sd, l2_hit, li >= 0],
        [SB[C.SC_BACK_REF] + br, SB[C.SC_SMALL_DIFF] + sr + 7 * sg + 49 * sb,
         SB[C.SC_LUMA_BASE_DIFF2] + byte(l2, 0), SB[C.SC_LUMA_BACK_REF] + li], SB[C.SC_RGB] + byte(z, 11))
    three = (mode != C.PREFIX_BACK_REF) & (mode != C.PREFIX_SMALL_DIFF)
    lu, is_l2 = mode == C.PREFIX_COLOR_LUMA, mode == C.PREFIX_COLOR_LUMA2
    out[:, 2] = np.where(three, np.select([is_l2, lu], [SB[C.SC_LUMA_OTHER_DIFF2] + byte(l2, 11),
                                                        SB[C.SC_LUMA_BASE_DIFF] + byte(lx, 0)],
                                          SB[C.SC_RGB] + byte(z, 0)), invalid)
    out[:, 3] = np.where(three, np.select([is_l2, lu], [SB[C.SC_LUMA_OTHER_DIFFB2] + byte(l2, 22),
                                                        SB[C.SC_LUMA_OTHER_DIFF] + byte(lx, 11)],
                                          SB[C.SC_RGB] + byte(z, 22)), invalid)
    out[:, 4] = np.where(lu, SB[C.SC_LUMA_OTHER_DIFF] + byte(lx, 22), invalid)
    run = nxt - pos - 1
    v = np.maximum(run - 1, 0)
    ndigits = np.where(run > 0, np.maximum(1, (sum((v >> j) > 0 for j in range(32)) + 2) // 3), 0)
    for j in range(cap):
        out[:, 5 + j] = np.where(j < ndigits, SB[C.SC_PREFIXES] + C.PREFIX_RUN_BASE + ((v >> (3 * j)) & 7), invalid)
    return out, (ndigits > cap) & (cap < C.MAX_RUN_DIGITS)


def _model_tokenize(x_ext, *, width, halo, g0, n_total, ndigits_cap, invalid_bin, tail=None, seed=0):
    """The kernel in numpy: (bins (B, n_local * S), overflow (B,))."""
    x = x_ext.numpy()
    B, n_ext, _ = x.shape
    n_local, S = n_ext - halo, 5 + ndigits_cap
    tail = [] if tail is None else tail.tolist()
    bins = np.full((B, n_local, S), invalid_bin, dtype=np.int64)
    ovf = np.zeros(B, bool)
    changed = np.zeros((B, n_local), bool)
    stages = {}
    for b in range(B):
        for s in range(0, n_local, SPAN):
            n = min(SPAN, n_local - s)
            st, bases = stages[b, s] = _stage(x.reshape(-1), b * n_ext, halo + s, n, width)
            p = np.arange(n)
            changed[b, s : s + n] = (g0 + s + p == 0) | (_read(st, bases, width, 0, p)
                                                        != _read(st, bases, width, 1, p))
    nxt = _model_next(torch.from_numpy(changed), g0, n_total, tail, span=SPAN, warp=32, resident=8,
                      seed=seed).numpy()
    for (b, s), (st, bases) in stages.items():
        n = min(SPAN, n_local - s)
        p = np.flatnonzero(changed[b, s : s + n])
        if p.size:
            out, over = _cascade(st, bases, width, g0 + s, p, nxt[b, s + p], ndigits_cap, invalid_bin)
            bins[b, s + p] = out
            ovf[b] |= over.any()
    return torch.from_numpy(bins.reshape(B, -1).astype(np.int32)), torch.from_numpy(ovf)


def _raster_case(name):
    """(x_ext, tokenize_bins keywords but the cap)."""
    rng = np.random.default_rng(len(name))
    if name == "sharded":  # rank 1 of 4 row blocks of 64 x 40, a halo, its last run ended by the tail
        img = _image(64, 40, 3)
        img[29:37] = img[29, 0]
        x, halo, n_local = img.reshape(-1, 3), ttok.halo_pixels(40), 16 * 40
        return (torch.from_numpy(np.ascontiguousarray(x[n_local - halo : 2 * n_local]))[None],
                dict(width=40, halo=halo, g0=n_local, n_total=64 * 40, invalid_bin=C.TOTAL_SYMBOLS,
                     tail=torch.tensor([37 * 40, 48 * 40], dtype=torch.int32)))
    if name == "rank0":  # rank 0's shard: a halo of zeros before the raster
        img = _image(32, 24, 4)
        halo = ttok.halo_pixels(24)
        x = np.concatenate([np.zeros((halo, 3), np.uint8), img.reshape(-1, 3)[: 8 * 24]])
        return (torch.from_numpy(x)[None], dict(width=24, halo=halo, g0=0, n_total=32 * 24,
                                                invalid_bin=C.TOTAL_SYMBOLS,
                                                tail=torch.tensor([300], dtype=torch.int32)))
    H, W = {"W4": (700, 4), "W5": (301, 5), "W64": (48, 64), "W1100": (5, 1100), "W29051": (3, 29051),
            "photo": (40, 96)}[name]
    imgs = [_image(H, W, s) for s in range(2)]
    if name == "photo":  # noise: every mode and every luma reference
        imgs = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) // 7 * 7 for _ in range(2)]
        imgs[1][5:9] = imgs[1][5, 3]
    x = torch.from_numpy(np.stack([im.reshape(-1, 3) for im in imgs]))
    return x, dict(width=W, halo=0, g0=0, n_total=H * W, invalid_bin=1023)


@pytest.mark.parametrize("cap", [0, 3, 5, C.MAX_RUN_DIGITS])
@pytest.mark.parametrize("name", ["W4", "W5", "W64", "W1100", "W29051", "photo", "sharded", "rank0"])
def test_kernel_model_matches_plain(name, cap):
    """The kernel's arithmetic (packed lanes, the luma and small-difference
    tricks, the position masks of the edge spans, the run digits) and its
    schedule together equal the plain version bit for bit."""
    x, kw = _raster_case(name)
    got = _model_tokenize(x, ndigits_cap=cap, **kw)
    want = ttok.tokenize_bins_plain(x, ndigits_cap=cap, **kw)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


# ---------------------------------------------------------------------------
# tokenize_bins on the CPU against JAX
# ---------------------------------------------------------------------------


def _image(H, W, seed):
    """Smooth rows with noise, a run over rows and one over many tiles."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([(yy * 3 + xx * 5) % 256, (yy * 7) % 256, (xx * 2) % 256], axis=2)
    img = (img + rng.integers(-2, 3, (H, W, 3))).clip(0, 255).astype(np.uint8)
    img[H // 4 : H // 2] = img[H // 4, 0]
    return img


@pytest.mark.parametrize("ndigits_cap", [3, C.MAX_RUN_DIGITS])
@pytest.mark.parametrize("W", [4, 5, 1100])
def test_tokenize_bins_matches_jax_tokenize_core(W, ndigits_cap):
    """Batched: a smooth image with runs, and one that changes only at its
    last pixel, whose run needs more than 3 base-8 digits (overflow at cap
    3 only)."""
    H = 3 if W == 1100 else 160
    a = _image(H, W, W)
    last = np.zeros((H, W, 3), np.uint8)
    last[-1, -1] = 9
    flat = np.stack([a.reshape(-1, 3), last.reshape(-1, 3)])
    before = dict(cuda_ops.LAUNCHES)
    tb, to = ttok.tokenize_bins(torch.from_numpy(flat), width=W, halo=0, g0=0, n_total=H * W,
                                ndigits_cap=ndigits_cap, invalid_bin=1023)
    assert cuda_ops.LAUNCHES == before  # the CPU runs the plain version: no launch
    core = jax.jit(jax.vmap(partial(jenc._tokenize_core, width=W, ndigits_cap=ndigits_cap)))
    jb, jo = core(jnp.asarray(flat))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert bool(to[1]) == (ndigits_cap == 3)


@pytest.mark.parametrize("ndigits_cap", [3, C.MAX_RUN_DIGITS])
@pytest.mark.parametrize("W", [4, 9])
def test_tokenize_bins_matches_jax_with_a_halo_and_a_tail(W, ndigits_cap):
    """A shard's slice: local pixels [g0, g0 + n_local) after a 4-row halo,
    the last run ended by the tail; against JAX's cascade + assemble_bins
    with the run lengths the sharded encode gives them."""
    img = _image(300, W, 3)
    img[24:] = img[23, -1]  # the shard ends inside a run of over 512 pixels that a later shard ends
    x = img.reshape(-1, 3)
    N, halo = x.shape[0], jtok.halo_pixels(W)
    g0, n_local, tail = 12 * W, 12 * W, [283 * W + 2, 250 * W]
    x_ext = np.ascontiguousarray(x[g0 - halo : g0 + n_local])
    jc = jtok.cascade(jnp.asarray(x_ext.astype(np.int32)), jnp.int32(g0), n_local, width=W, halo=halo)
    changed, pos = np.asarray(jc["changed"]), np.asarray(jc["pos"])
    sfx = np.minimum.accumulate(np.where(changed, pos, N)[::-1])[::-1]
    run_len = np.minimum(np.concatenate([sfx[1:], [N]]), min(tail)) - pos - 1
    jb, jo = jtok.assemble_bins(jc, jnp.asarray(run_len.astype(np.int32)), ndigits_cap=ndigits_cap,
                                invalid_bin=C.TOTAL_SYMBOLS)
    tb, to = ttok.tokenize_bins(torch.from_numpy(x_ext)[None], width=W, halo=halo, g0=g0, n_total=N,
                                ndigits_cap=ndigits_cap, invalid_bin=C.TOTAL_SYMBOLS,
                                tail=torch.tensor(tail, dtype=torch.int32))
    np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb).reshape(-1))
    assert bool(to[0]) == bool(jo) == (ndigits_cap == 3)


def _bad_inputs():
    ok = torch.zeros(1, 64, 3, dtype=torch.uint8)
    return {
        "int32": (ok.to(torch.int32), {}),
        "4 channels": (torch.zeros(1, 64, 4, dtype=torch.uint8), {}),
        "2-D": (ok[0], {}),
        "not contiguous": (torch.zeros(1, 3, 64, dtype=torch.uint8).transpose(1, 2), {}),
        "width 3": (ok, {"width": 3}),
        "halo past the pixels": (ok, {"halo": 64}),
        "cap 12": (ok, {"ndigits_cap": 12}),
        "pixels past n_total": (ok, {"n_total": 63}),
        "int64 tail": (ok, {"tail": torch.zeros(1, dtype=torch.int64)}),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_tokenize_bins_rejects(case):
    x, kw = _bad_inputs()[case]
    args = dict(width=8, halo=0, g0=0, n_total=64, ndigits_cap=3, invalid_bin=1023) | kw
    with pytest.raises((TypeError, ValueError)):
        ttok.tokenize_bins(x, **args)
