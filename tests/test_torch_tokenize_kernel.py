"""The tokenizer kernel's scheme and its wrapper on the CPU.

`csrc/tokenize_kernels.cu` finds each pixel's next change in three passes:
each tile's first change, a suffix minimum over the tiles (segments of the
tile row, one a thread, joined by a Hillis-Steele minimum), and in the main
pass a warp ballot, the tile's later warps and the later tiles, ended by
the tail (the later shards' first changes).  A torch model of that scheme,
at tiles, warps and thread counts small enough to force every boundary, is
held against `suffix_min`; `tokenize.tokenize_bins`, which runs its plain
version on a CPU tensor, is held against JAX's `cascade` + `assemble_bins`
with a halo and against `jax.vmap(_tokenize_core)`.  Every comparison is
bit-exact.
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
# the three-pass run scheme, modelled in torch
# ---------------------------------------------------------------------------


def _model_tiles(changed, pos, n_total, tile, threads):
    """Passes 1 and 2: (B, T + 1), the first change at or after each tile."""
    B, n = changed.shape
    T = -(-n // tile)
    big = torch.full((B, T * tile), n_total, dtype=torch.int64)
    big[:, :n] = torch.where(changed, pos, n_total)
    tiles = torch.full((B, T + 1), n_total, dtype=torch.int64)
    tiles[:, :T] = big.view(B, T, tile).amin(dim=2)
    per = -(-T // threads)
    for b in range(B):
        row = tiles[b]
        bounds = [(min(T, s * per), min(T, s * per + per)) for s in range(threads)]
        seg = [min(row[lo:hi].tolist(), default=n_total) for lo, hi in bounds]
        d = 1
        while d < threads:  # Hillis-Steele: seg[s] becomes min(seg[s:])
            seg = [min(seg[s], seg[s + d] if s + d < threads else n_total) for s in range(threads)]
            d *= 2
        for s, (lo, hi) in enumerate(bounds):
            run = seg[s + 1] if s + 1 < threads else n_total
            for k in range(hi - 1, lo - 1, -1):
                run = min(run, int(row[k]))
                row[k] = run
        row[T] = n_total
    return tiles


def _model_next(changed, g0, n_total, tail, *, tile, warp, threads):
    """Pass 3's next change of every pixel: a ballot in its warp, the tile's
    later warps' firsts, the next tile's entry, the tail."""
    B, n = changed.shape
    pos = torch.arange(n, dtype=torch.int64) + g0
    tiles = _model_tiles(changed, pos, n_total, tile, threads)
    none = 2**31 - 1
    out = torch.empty(B, n, dtype=torch.int64)
    for b in range(B):
        for t in range(-(-n // tile)):
            lanes = [[i for i in range(t * tile + w, t * tile + w + warp)] for w in range(0, tile, warp)]
            ballots = [sum(1 << l for l, i in enumerate(ws) if i < n and bool(changed[b, i])) for ws in lanes]
            firsts = [ws[0] + g0 + (bl & -bl).bit_length() - 1 if bl else none for ws, bl in zip(lanes, ballots)]
            for w, ws in enumerate(lanes):
                for lane, i in enumerate(ws):
                    if i >= n:
                        continue
                    later = ballots[w] & ~((2 << lane) - 1)
                    nxt = i + g0 - lane + (later & -later).bit_length() - 1 if later else none
                    nxt = min([nxt, *firsts[w + 1 :], int(tiles[b, t + 1]), *tail])
                    out[b, i] = nxt
    return out, tiles


def _reference_next(changed, g0, n_total, tail):
    pos = torch.arange(changed.shape[1], dtype=torch.int64) + g0
    sfx = suffix_min(torch.where(changed, pos, n_total))
    nxt = torch.cat([sfx[:, 1:], torch.full((changed.shape[0], 1), n_total, dtype=torch.int64)], dim=1)
    return torch.minimum(nxt, torch.tensor(min([n_total, *tail]), dtype=torch.int64))


def _changes(name, n, tile):
    rng = np.random.default_rng(n)
    c = np.zeros((3, n), bool)
    if name == "all_run":
        c[:, 0] = True  # pixel 0 only: one run to the end
    elif name == "last_pixel":
        c[:, 0] = True
        c[:, -1] = True
    elif name == "tile_edges":
        c[:, ::tile] = True
        c[1, tile - 1 :: tile] = True
        c[2, ::tile] = False
        c[2, tile - 1 :: tile] = True
    elif name == "sparse":
        c = rng.random((3, n)) < 0.02
    elif name == "none":  # a shard with no change at all
        pass
    return torch.from_numpy(c)


RUN_CASES = ["all_run", "last_pixel", "tile_edges", "sparse", "none"]
# (tile, warp, threads of the suffix pass): small ones cut every boundary
SCHEMES = [(8, 4, 2), (16, 4, 3), (32, 8, 4), (256, 32, 1024)]


@pytest.mark.parametrize("tile,warp,threads", SCHEMES)
@pytest.mark.parametrize("case", RUN_CASES)
def test_run_scheme_matches_suffix_min(case, tile, warp, threads):
    n = 5 * tile + 3  # a ragged last tile
    changed = _changes(case, n, tile)
    for g0, n_total, tail in ((0, n, []), (2 * n, 4 * n, [3 * n + 5, 3 * n + 1]), (n, 2 * n, [])):
        got, tiles = _model_next(changed, g0, n_total, tail, tile=tile, warp=warp, threads=threads)
        want = _reference_next(changed, g0, n_total, tail)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        # column 0 is what a shard all-gathers: its first change, else n_total
        firsts = torch.where(changed, torch.arange(n) + g0, n_total).amin(dim=1)
        np.testing.assert_array_equal(tiles[:, 0].numpy(), firsts.numpy())


def _halo_raster(H, W, seed):
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 4, (H, W, 3)) * 60).astype(np.uint8)
    img[H // 3 : H // 2] = img[H // 3, 0]  # a run over rows
    return img.reshape(-1, 3)


@pytest.mark.parametrize("W", [4, 7, 300])
def test_change_tiles_plain_matches_the_model(W):
    """The wrapper's tile layout (TOKENIZE_TILE pixels a tile) from real
    rasters, with and without a halo."""
    flat = np.stack([_halo_raster(24, W, s) for s in (1, 2)])
    halo = ttok.halo_pixels(W)
    N = flat.shape[1]
    for g0 in (0, 8 * W):
        x_ext = torch.from_numpy(np.ascontiguousarray(flat[:, max(g0 - halo, 0) :]))
        h = min(g0, halo)
        got = ttok.change_tiles(x_ext, halo=h, g0=g0, n_total=N)
        x = x_ext.to(torch.int32)
        prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        changed = (x != prev).any(dim=2)[:, h:]
        changed[:, 0] |= g0 == 0
        _, want = _model_next(changed, g0, N, [], tile=cuda_ops.TOKENIZE_TILE, warp=32, threads=1024)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


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
