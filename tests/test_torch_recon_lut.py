"""A CPU model of the row reconstruction kernel's segment schedule.

`reconstruct_rows_kernel` (nicetpu_torch/csrc/decode_kernels.cu) runs the
value chain row by row; within a row it builds, for each segment of L
pixels, three 256-entry LUTs (the segment's last three values for every
candidate entry value), tags naming the entry lag each LUT reads, resolves
the true entry triples across the segments (past 32 segments through a
two-level resolve over groups of 16 composed segments), replays every
segment from its triple, and recomputes the last 3 columns (their CONST
references land in columns 0..2 of the same row).  `_model` below does the
same steps in numpy for any segment length L, with the kernel's candidate
step: every form is v = ((k * x + c) >> 1) & 255, and a value v rides as
the float 2^23 + v through one multiply-add rounded toward zero and a mask
of the low byte (emulated exactly in float64).  It is held, exactly,
against the port's plain
`decode_dev.reconstruct_rows` and, where L divides W, against JAX's
segment-LUT `decode_dev.reconstruct_rows(..., segs=W // L)`.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.kernels import decode_dev as jdd
from nicetpu_torch.kernels import decode_dev as tdd

TWO23 = float(2**23)


def _float_step(x, k, c):
    """The kernel's step on x = 2^23 + v (float64 holds float32's exact
    values here): fma_rz(x, k / 2, 2^23 - k 2^22 + c / 2), then the low byte
    of the result's bits, which for 2^23 <= t < 2^24 are t - 2^23."""
    h = k / 2.0
    a = TWO23 - k * 2.0**22 + c / 2.0
    assert np.all(np.float32(a) == a)  # every operand is exact in float32
    t = np.floor(x * h + a)  # exact product and sum, rounded toward zero
    assert np.all((t >= TWO23) & (t < 2 * TWO23))
    return TWO23 + ((t - TWO23).astype(np.int64) & 255)


GROUP = 16  # the kernel's kGroup


def _run(luts, tags, trip, segs):
    """Entry triples of `segs` in order from the entry triple `trip`."""
    out = {}
    for s in segs:
        out[s] = trip
        trip = [int(luts[k][s, trip[tags[s, k]]]) for k in range(3)]
    return out


def _resolve(luts, tags, trip):
    """The kernel's resolve: serial up to 2 * GROUP segments; beyond, each
    group of GROUP segments is composed into one LUT triple with tags, the
    triple is carried across the groups, then across each group."""
    S = tags.shape[0]
    if S <= 2 * GROUP:
        out = _run(luts, tags, trip, range(S))
        return [out[s] for s in range(S)]
    groups = [range(g, min(S, g + GROUP)) for g in range(0, S, GROUP)]
    g_luts = [np.zeros((len(groups), 256), np.int64) for _ in range(3)]
    g_tags = np.zeros((len(groups), 3), np.int64)
    for gi, segs in enumerate(groups):
        v = [np.arange(256)] * 3
        g = [0, 1, 2]
        for s in segs:
            a = tags[s]
            v = [luts[k][s, v[a[k]]] for k in range(3)]
            g = [g[a[k]] for k in range(3)]
        for k in range(3):
            g_luts[k][gi] = v[k]
        g_tags[gi] = g
    g_trip = _run(g_luts, g_tags, trip, range(len(groups)))
    out = {}
    for gi, segs in enumerate(groups):
        out.update(_run(luts, tags, g_trip[gi], segs))
    return [out[s] for s in range(S)]


def _model(form, delta, refoff, width: int, seg: int):
    """One (image, channel): form, delta, refoff (N,) int -> (N,) values."""
    W, L = width, seg
    H = form.shape[0] // W
    S = -(-W // L)
    f_all = np.where((form >= 0) & (form <= 3), form, 4)
    ring = np.zeros((4, W), np.int64)  # rows r-4 .. r-1 in slot (row & 3)
    out = np.zeros((H, W), np.int64)
    for r in range(H):
        f, d = f_all[r * W : (r + 1) * W], delta[r * W : (r + 1) * W] & 255
        ro = refoff[r * W : (r + 1) * W]
        above = ring[(r + 3) & 3]
        # stage: CONST values from the ring; references into this row are
        # read as 0 here (cc marks them) and fixed up at the end
        cv = np.zeros(W, np.int64)
        cc = np.zeros(W, np.int64)
        for x in range(W):
            if ro[x] > 0:
                k = x - int(ro[x])
                if k >= 0:
                    cc[x] = k + 1
                else:
                    back = (W - 1 - k) // W
                    cv[x] = ring[(r - back) & 3][k + back * W] if r >= back else 0
        cc = np.where(f == 0, cc, 0)  # only CONST reads its reference
        # the kernel's per-pixel (lag, k, c): v = ((k * x + c) >> 1) & 255
        lag = np.where((f >= 1) & (f <= 3), f, 1)
        k_px = np.where(f == 0, 0, np.where(f == 4, 1, 2))
        c_px = np.where(f == 0, 2 * ((cv + d) & 255), np.where(f == 4, above + 2 * d, 2 * d))
        # build: (S, 256) candidates per lag, as floats; tags per segment
        r1 = np.broadcast_to(TWO23 + np.arange(256.0), (S, 256)).copy()
        r2, r3 = r1.copy(), r1.copy()
        t1, t2, t3 = np.zeros(S, int), np.ones(S, int), np.full(S, 2)
        for j in range(L):
            x = np.arange(S) * L + j
            live = x < W  # a ragged last segment stops early
            xc = np.minimum(x, W - 1)
            lj = lag[xc]
            xv = np.where(lj[:, None] == 3, r3, np.where(lj[:, None] == 2, r2, r1))
            new = _float_step(xv, k_px[xc][:, None], c_px[xc][:, None])
            tn = np.where(lj == 2, t2, np.where(lj == 3, t3, t1))
            lv = live[:, None]
            r1, r2, r3 = np.where(lv, new, r1), np.where(lv, r1, r2), np.where(lv, r2, r3)
            t1, t2, t3 = np.where(live, tn, t1), np.where(live, t1, t2), np.where(live, t2, t3)
        luts = [(r - TWO23).astype(np.int64) for r in (r1, r2, r3)]  # (S, 256) each
        # resolve: entry triple of each segment, three byte lookups a segment
        trip = [int(above[W - 1]), int(above[W - 2]), int(above[W - 3])]
        bnd = _resolve(luts, np.stack([t1, t2, t3], axis=1), trip)

        def one(x, v1, v2, v3, c):  # the step on one value, with selects
            xl = (v1, v2, v3)[lag[x] - 1]
            return int(_float_step(TWO23 + xl, k_px[x], c) - TWO23)

        # replay: every segment from its true entry triple
        row = np.zeros(W, np.int64)
        for s in range(S):
            v1, v2, v3 = bnd[s]
            for x in range(s * L, min((s + 1) * L, W)):
                v = one(x, v1, v2, v3, c_px[x])
                row[x], v1, v2, v3 = v, v, v1, v2
        # fix-up: the last 3 columns, serially, with this row's columns 0..2
        for x in range(W - 3, W):
            c = 2 * ((row[cc[x] - 1] + d[x]) & 255) if cc[x] else c_px[x]
            prev = [row[x - k] if x >= k else above[W + x - k] for k in (1, 2, 3)]
            row[x] = one(x, *prev, c)
        ring[r & 3] = row
        out[r] = row
    return out.reshape(-1)


def _inputs(B, H, W, seed):
    """Random forms (a few outside 0..4, which read as HALF) and CONST
    references as in test_torch_cuda, with CONST references forced into
    the last 3 columns wherever an offset lands in this row and HALF at
    column 0."""
    rng = np.random.default_rng(seed)
    N = H * W
    form = rng.integers(0, 5, (B, N)).astype(np.int32)
    form[rng.random((B, N)) < 0.02] = 6
    delta = rng.integers(0, 256, (B, 3, N)).astype(np.int32)
    offs = tdd._const_offsets(W)
    refoff = np.where(form == 0, rng.choice(np.array([0] + offs, np.int32), (B, N)), 0)
    f2, r2 = form.reshape(B, H, W), refoff.reshape(B, H, W)
    f2[:, :, 0] = 4
    r2[:, :, 0] = 0
    for x in range(W - 3, W):
        same_row = [o for o in offs if 0 <= x - o <= 2]
        if same_row:
            f2[:, :, x] = 0
            r2[:, :, x] = rng.choice(same_row, (B, H))
    return form, delta, refoff.astype(np.int32)


def _check(B, H, W, L):
    form, delta, refoff = _inputs(B, H, W, seed=W * 100 + L)
    want = tdd.reconstruct_rows(*(torch.from_numpy(a) for a in (form, delta, refoff)), H * W, W)
    got = np.stack([np.stack([_model(form[b], delta[b, c], refoff[b], W, L)
                              for c in range(3)]) for b in range(B)])
    np.testing.assert_array_equal(got, want.numpy())
    return form, delta, refoff, got


@pytest.mark.parametrize("W", [4, 20, 37, 512])
@pytest.mark.parametrize("L", [4, 7, 32])
def test_schedule_matches_plain(W, L):
    _check(2, 3 if W == 512 else 5, W, L)


# where L divides W (JAX needs segments of at least 4 pixels)
@pytest.mark.parametrize("W,L", [(4, 4), (20, 4), (512, 32)])
def test_schedule_matches_jax_segment_luts(W, L):
    H = 3 if W == 512 else 5
    form, delta, refoff, got = _check(2, H, W, L)
    jrecon = jax.jit(jax.vmap(partial(jdd.reconstruct_rows, n_pixels=H * W, width=W, segs=W // L)))
    want = jrecon(jnp.asarray(form), jnp.asarray(delta), jnp.asarray(refoff))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_inputs_reach_the_fixup():
    """The forced CONST references do land in the current row."""
    form, _, refoff = _inputs(1, 3, 20, seed=0)
    x = np.arange(3 * 20) % 20
    assert ((form[0] == 0) & (refoff[0] > 0) & (x - refoff[0] >= 0)).sum() >= 3
