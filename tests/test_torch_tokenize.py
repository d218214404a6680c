"""PyTorch tokenizer (nicetpu_torch.kernels.{scan,tokenize,encode2}) vs the
JAX reference on the same numpy inputs.  Every comparison is bit-exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.format import constants as C
from nicetpu.kernels import encode2 as jenc
from nicetpu.kernels import scan as jscan
from nicetpu.kernels import tokenize as jtok
from nicetpu_torch.kernels import encode2 as tenc
from nicetpu_torch.kernels import scan as tscan
from nicetpu_torch.kernels import tokenize as ttok

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURES = ["flat9x7", "gradient16x12", "mixed20x14", "random8x6"]  # tests/data/*.npy


def _images():
    """The repo's golden rasters plus small seeded images with runs and noise."""
    out = {name: np.load(os.path.join(DATA, f"{name}.npy")) for name in FIXTURES}
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        img = (rng.integers(0, 6, (12, 16, 3)) * 40).astype(np.uint8)
        img[4:7] = img[4, 0]  # a run over rows
        out[f"rand12x16_{seed}"] = img
    ramp = np.zeros((12, 16, 3), np.uint8)
    ramp[..., 0] = np.arange(16, dtype=np.uint8)[None, :] * 3
    ramp[..., 1] = 7
    out["ramp12x16"] = ramp
    return out


IMAGES = _images()


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_suffix_min(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 50, n).astype(np.int32)
    _eq(tscan.suffix_min(torch.from_numpy(x)), jscan.suffix_min(jnp.asarray(x)))


def _run_len_np(changed, pos, N):
    change_idx = np.where(changed, pos, N)
    sfx = np.minimum.accumulate(change_idx[::-1])[::-1]
    return np.concatenate([sfx[1:], [N]]) - pos - 1


@pytest.mark.parametrize("ndigits_cap", [3, C.MAX_RUN_DIGITS])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_cascade_assemble_bins(name, ndigits_cap):
    img = IMAGES[name]
    H, W, _ = img.shape
    N = H * W
    x = img.reshape(N, 3).astype(np.int32)
    jc = jtok.cascade(jnp.asarray(x), jnp.int32(0), N, width=W, halo=0)
    tc = ttok.cascade(torch.from_numpy(x), 0, N, width=W, halo=0)
    for key in ("pos", "mode", "br_idx", "sd_code", "changed"):
        _eq(tc[key], jc[key])
    for key in ("l2", "lu", "res"):
        for t, j in zip(tc[key], jc[key]):
            _eq(t, j)
    run_len = _run_len_np(np.asarray(jc["changed"]), np.asarray(jc["pos"]), N).astype(np.int32)
    jb, jo = jtok.assemble_bins(
        jc, jnp.asarray(run_len), ndigits_cap=ndigits_cap, invalid_bin=tenc.INVALID_BIN
    )
    tb, to = ttok.assemble_bins(
        tc, torch.from_numpy(run_len), ndigits_cap=ndigits_cap, invalid_bin=tenc.INVALID_BIN
    )
    _eq(tb, jb)
    assert bool(to) == bool(jo)


def test_cascade_halo_slice():
    """Halo-extended shard slice (the signature sharding reuses): local
    pixels [g0, g0 + n_local) of a raster with a 4-row halo."""
    img = IMAGES["rand12x16_0"]
    H, W, _ = img.shape
    x = img.reshape(-1, 3).astype(np.int32)
    halo = jtok.halo_pixels(W)
    g0, n_local = 5 * W, 4 * W
    x_ext = x[g0 - halo : g0 + n_local]
    jc = jtok.cascade(jnp.asarray(x_ext), jnp.int32(g0), n_local, width=W, halo=halo)
    tc = ttok.cascade(torch.from_numpy(x_ext), g0, n_local, width=W, halo=halo)
    for key in ("pos", "mode", "br_idx", "sd_code", "changed"):
        _eq(tc[key], jc[key])
    for t, j in zip(tc["lu"] + tc["l2"] + tc["res"], jc["lu"] + jc["l2"] + jc["res"]):
        _eq(t, j)


def _seeded_groups():
    imgs = [IMAGES["rand12x16_0"], IMAGES["ramp12x16"], np.zeros((12, 16, 3), np.uint8)]
    imgs[2][0, 0] = 1
    long = np.zeros((24, 32, 3), np.uint8)  # 767-pixel run: needs 4 digits
    long[0, 0] = 3
    return [imgs, [long]]


def _fixture_groups(name):
    img = IMAGES[name]
    return [[img, np.ascontiguousarray(img[::-1])]]


# the seeded groups keep the bare ndigits_cap ids; each golden fixture is
# batched with its upside-down copy
TOKENIZE_CASES = [
    pytest.param(None, cap, id=str(cap)) for cap in (3, C.MAX_RUN_DIGITS)
] + [
    pytest.param(name, cap, id=f"{name}-{cap}")
    for name in FIXTURES for cap in (3, C.MAX_RUN_DIGITS)
]


@pytest.mark.parametrize("source,ndigits_cap", TOKENIZE_CASES)
def test_tokenize_core_batched(source, ndigits_cap):
    """The port's batched _tokenize_core equals JAX's per-image one,
    including the run-overflow flag: a 767-pixel run needs 4 base-8
    digits, which overflows the 3-digit layout only."""
    groups = _seeded_groups() if source is None else _fixture_groups(source)
    for group in groups:
        B = len(group)
        H, W, _ = group[0].shape
        flat = np.stack([im.reshape(H * W, 3) for im in group])
        tb, to = tenc._tokenize_core(torch.from_numpy(flat), width=W, ndigits_cap=ndigits_cap)
        for b in range(B):
            jb, jo = jenc._tokenize_core(jnp.asarray(flat[b]), width=W, ndigits_cap=ndigits_cap)
            _eq(tb[b], jb)
            assert bool(to[b]) == bool(jo)
    if source is None:
        assert bool(to[0]) == (ndigits_cap == 3)
