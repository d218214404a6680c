"""A CPU model of the row reconstruction on a thread-block cluster.

`reconstruct_rows_cluster_kernel` (nicetpu_torch/csrc/decode_kernels.cu)
splits each row's segments evenly over the C CTAs of a cluster; each CTA
keeps only its own columns of the four-row ring and reads the columns of
the rows above that lie in another slice from the CTA that owns them.  A
row resolves in three levels: each CTA composes its groups of segments
into one LUT triple, every CTA carries the row's entry triple across the
triples of the CTAs before it and on across its own groups, then across
each group's segments.  The last CTA fixes up the row's last three
columns with columns 0..2, which it computes from the first CTA's first
three pixels and the row's entry triple.  `_model` does the same in
numpy, with the kernel's one-expression step v = ((k x + c) >> 1) & 255
(`test_torch_recon_lut.py` holds the kernel's float form of that step),
for any segment length, group size and number of CTAs, and is held
exactly against the port's plain `decode_dev.reconstruct_rows`, with and
without the carry."""

import numpy as np
import pytest
import torch

from nicetpu_torch.kernels import decode_dev, recon

from _recon_rows import random_inputs, seam_inputs


def _step(x, k, c):
    return ((k * x + c) >> 1) & 255


def _slices(S: int, C: int) -> list[range]:
    """The kernel's split: CTA j owns segments [j S / C, (j + 1) S / C)."""
    return [range(j * S // C, (j + 1) * S // C) for j in range(C)]


def _owner(col: int, seg: int, S: int, C: int) -> int:
    """The kernel's owner of a column, without a search."""
    return -(-((col // seg + 1) * C) // S) - 1


def _compose(items):
    """One LUT triple and its tags from a sequence of (luts (3, 256), tags)."""
    v = [np.arange(256)] * 3
    g = [0, 1, 2]
    for luts, a in items:
        v = [luts[k][v[a[k]]] for k in range(3)]
        g = [g[a[k]] for k in range(3)]
    return np.stack(v), g


def _run(items, trip):
    """The entry triple of each item, carried from `trip`."""
    out = []
    for luts, a in items:
        out.append(trip)
        trip = tuple(int(luts[k][trip[a[k]]]) for k in range(3))
    return out


def _build(lag, k, c):
    """One segment's LUT triple over the 256 candidate entry values, and its
    tags (the entry lag each of its last three values reads)."""
    v = [np.arange(256)] * 3
    t = [0, 1, 2]
    for x in range(len(lag)):
        new = _step(v[lag[x] - 1], k[x], c[x])
        v = [new, v[0], v[1]]
        t = [t[lag[x] - 1], t[0], t[1]]
    return np.stack(v), t


def _model(form, delta, refoff, W: int, seg: int, C: int, group: int, prev4=None):
    """One (image, channel): form, delta, refoff (N,) -> (N,) values."""
    H = form.shape[0] // W
    S = -(-W // seg)
    sl = _slices(S, C)
    x0 = [s.start * seg for s in sl]
    x1 = [min(W, s.stop * seg) for s in sl]
    assert all(len(s) >= 2 for s in sl) and x1[-1] - x0[-1] >= 6  # as the dispatch allows
    assert all(_owner(x, seg, S, C) == j for j in range(C) for x in range(x0[j], x1[j]))
    rings = [np.zeros((4, x1[j] - x0[j]), np.int64) for j in range(C)]
    if prev4 is not None:
        for j in range(C):
            rings[j][:] = prev4.reshape(4, W)[:, x0[j] : x1[j]]
    f_all = np.where((form >= 0) & (form <= 3), form, 4)
    out = np.zeros((H, W), np.int64)
    for r in range(H):
        def ring_at(slot, col):
            o = _owner(col, seg, S, C)
            return rings[o][slot, col - x0[o]]

        cols = range(r * W, (r + 1) * W)
        # 1. stage, each CTA its slice; references into this row read 0 (cc)
        lag = np.ones(W, np.int64)
        k_px = np.zeros(W, np.int64)
        c_px = np.zeros(W, np.int64)
        cc = np.zeros(W, np.int64)
        for x, i in enumerate(cols):
            f, d, ro = int(f_all[i]), int(delta[i]) & 255, int(refoff[i])
            if f == 0:
                cv = 0
                if ro > 0:
                    kk = x - ro
                    if kk >= 0:
                        cc[x] = kk + 1
                    else:
                        back = (W - 1 - kk) // W
                        cv = ring_at((r - back) & 3, kk + back * W)
                c_px[x] = 2 * ((cv + d) & 255)
            elif f <= 3:
                lag[x], k_px[x], c_px[x] = f, 2, 2 * d
            else:
                above = ring_at((r + 3) & 3, x)
                k_px[x], c_px[x] = 1, above + 2 * d
        # 2. build: every segment's LUT triple
        segs = [_build(lag[s * seg : (s + 1) * seg], k_px[s * seg : (s + 1) * seg],
                       c_px[s * seg : (s + 1) * seg]) for s in range(S)]
        # 3. resolve: the groups' triples, the CTAs' triples, the carry
        groups = [[range(g, min(s.stop, g + group)) for g in range(s.start, s.stop, group)] for s in sl]
        g_items = [[_compose([segs[s] for s in g]) for g in gj] for gj in groups]
        cta = [_compose(items) for items in g_items]
        e0 = tuple(int(ring_at((r + 3) & 3, W - 1 - u)) for u in range(3))
        entry = {}
        for j in range(C):
            g_entry = _run(cta[:j] + g_items[j], e0)[j:]
            for g, e in zip(groups[j], g_entry):
                entry.update(zip(g, _run([segs[s] for s in g], e)))
        # 4. replay
        row = np.zeros(W, np.int64)
        for s in range(S):
            v = entry[s]
            for x in range(s * seg, min(W, (s + 1) * seg)):
                new = _step(v[lag[x] - 1], k_px[x], c_px[x])
                row[x], v = new, (new, v[0], v[1])
        # 5. the last CTA: columns 0..2 from the first CTA's pixels, then the fix-up
        v, edge = e0, []
        for x in range(3):
            new = _step(v[lag[x] - 1], k_px[x], c_px[x])
            edge.append(new)
            v = (new, v[0], v[1])
        assert edge == list(row[:3])
        for x in range(W - 3, W):
            c = 2 * ((edge[cc[x] - 1] + (int(delta[r * W + x]) & 255)) & 255) if cc[x] else c_px[x]
            row[x] = _step(row[x - lag[x]], 0 if cc[x] else k_px[x], c)
        for j in range(C):
            rings[j][r & 3] = row[x0[j] : x1[j]]
        out[r] = row
    return out.reshape(-1)


def _check(B, H, W, seg, C, group, carry, make):
    form, delta, refoff = make(B, H, W, W * 7 + C, seg) if make is seam_inputs else make(B, H, W, W * 7 + C)
    prev4 = None
    if carry:
        prev4 = torch.from_numpy(np.random.default_rng(W).integers(0, 256, (B, 3, 4 * W)).astype(np.int32))
        want, _ = decode_dev.reconstruct_rows(form, delta, refoff, H * W, W, prev4=prev4)
    else:
        want = decode_dev.reconstruct_rows(form, delta, refoff, H * W, W)
    got = np.stack([np.stack([_model(form[b].numpy(), delta[b, c].numpy(), refoff[b].numpy(), W, seg, C,
                                     group, None if prev4 is None else prev4[b, c].numpy())
                              for c in range(3)]) for b in range(B)])
    np.testing.assert_array_equal(got, want.numpy())


# (W, segment length, CTAs, group): slices of 2 segments to many, ragged
# last segments, one group a slice and several, the last slice longer
@pytest.mark.parametrize("W,seg,C,group", [
    (37, 4, 2, 8), (37, 4, 3, 2), (64, 4, 8, 1), (100, 8, 3, 2), (101, 8, 4, 8), (203, 8, 5, 3),
    (203, 16, 6, 1),
])
@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
@pytest.mark.parametrize("make", [random_inputs, seam_inputs], ids=["random", "seams"])
def test_cluster_schedule_matches_plain(W, seg, C, group, carry, make):
    _check(1, 4, W, seg, C, group, carry, make)


def test_seam_inputs_cross_every_seam_and_the_wrap():
    """Every segment boundary has CONST references, lag 2 and lag 3 within
    3 columns on both sides, and the row's first and last columns read the
    rows above across the wrap."""
    W, H = 96, 6
    form, _, refoff = seam_inputs(1, H, W, 5, seg=16)
    form, refoff = form.numpy().reshape(H, W), refoff.numpy().reshape(H, W)
    for b in range(16, W, 16):
        for side in (range(b - 3, b), range(b, b + 3)):
            assert {0, 2, 3} <= set(form[:, side].ravel().tolist())
    x = np.arange(W)[None, :].repeat(H, 0)
    col = (x - refoff) % W  # the column a CONST reference reads
    wrap = (form == 0) & (refoff > 0) & (np.abs(col - x) > 3)
    assert wrap[:, :3].any() and wrap[:, -3:].any()


def test_cluster_ctas_is_0_on_the_cpu():
    assert recon.cluster_ctas(16384, "cpu") == 0 and recon.cluster_ctas(512, torch.device("cpu")) == 0


@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
def test_reconstruct_rows_counts_its_chains_on_the_cpu(carry):
    """`stats` gains 3 chains an image, none of them on a cluster on the CPU."""
    B, H, W = 2, 3, 40
    form, delta, refoff = random_inputs(B, H, W, 11)
    prev4 = torch.zeros(B, 3, 4 * W, dtype=torch.int32) if carry else None
    stats = {"recon_chains": 6}
    recon.reconstruct_rows(form, delta, refoff, width=W, prev4=prev4, stats=stats)
    assert stats == {"recon_chains": 6 + 3 * B, "recon_cluster_chains": 0}
