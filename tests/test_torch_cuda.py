"""The CUDA kernels and the device encode path of nicetpu_torch, on a GPU.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs where JAX is absent; skip the JAX conftest
there:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import nicetpu_torch
from nicetpu.format import constants as C
from nicetpu.hostref import oracle
from nicetpu_torch.kernels import cuda_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _bins(B, M, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, C.TOTAL_SYMBOLS, (B, M)).astype(np.int32)
    bins[rng.random((B, M)) < 0.3] = 1023
    bins[rng.random((B, M)) < 0.01] = -5  # any value outside [0, 858) is a hole
    return torch.from_numpy(bins)


def _tables(B, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 32, (B, C.TOTAL_SYMBOLS)).astype(np.int32)
    codes = rng.integers(0, 2**32, (B, C.TOTAL_SYMBOLS), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(lengths), torch.from_numpy(codes.view(np.int32))


def _slots(B, Mg, S, seed):
    rng = np.random.default_rng(seed)
    aob = rng.integers(0, 32, (B, Mg, S)).astype(np.int32)
    aob[rng.random((B, Mg, S)) < 0.4] = 0
    code = rng.integers(0, 2**32, (B, Mg, S), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(aob), torch.from_numpy(code.view(np.int32))


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# (1, 1_100_001): slices rounded up to multiples of 4 leave the last blocks
# of the grid with no tokens at all
@pytest.mark.parametrize("B,M", [(3, 100_003), (2, 4096), (1, 1), (5, 7), (1, 1_100_001)])
def test_histogram_and_join_match_plain(dev, B, M):
    bins = _bins(B, M, seed=M).to(dev)
    lengths, codes = (t.to(dev) for t in _tables(B, seed=1))
    before = dict(cuda_ops.LAUNCHES)
    _same(cuda_ops.histogram(bins), cuda_ops.histogram_plain(bins))
    _same(cuda_ops.table_join(bins, lengths, codes), cuda_ops.table_join_plain(bins, lengths, codes))
    assert cuda_ops.LAUNCHES["histogram"] == before["histogram"] + 1
    assert cuda_ops.LAUNCHES["table_join"] == before["table_join"] + 1


def test_join_on_an_unaligned_view(dev):
    """A one-row view starting one element in: the kernels take their
    scalar path instead of int4 loads."""
    bins = _bins(1, 5001, seed=3).to(dev)[:, 1:]
    assert bins.is_contiguous() and bins.data_ptr() % 16 != 0
    lengths, codes = (t.to(dev) for t in _tables(1, seed=4))
    _same(cuda_ops.histogram(bins), cuda_ops.histogram_plain(bins))
    _same(cuda_ops.table_join(bins, lengths, codes), cuda_ops.table_join_plain(bins, lengths, codes))


@pytest.mark.parametrize("S", [64, 128, 16, 13])
def test_fold_matches_plain(dev, S):
    aob, code = (t.to(dev) for t in _slots(2, 1000, S, seed=S))
    before = cuda_ops.LAUNCHES["fold_records"]
    _same(cuda_ops.fold_records(aob, code), cuda_ops.fold_records_plain(aob, code))
    assert cuda_ops.LAUNCHES["fold_records"] == before + 1


def test_wrappers_reject_mixed_devices(dev):
    bins = _bins(1, 64, seed=5).to(dev)
    lengths, codes = _tables(1, seed=6)  # left on the CPU
    with pytest.raises(ValueError):
        cuda_ops.table_join(bins, lengths, codes)


def test_encode_batch_cuda_matches_native(dev):
    rng = np.random.default_rng(7)
    smooth = np.clip(
        128 + 40 * np.sin(np.arange(48)[None, :, None] / 5.0)
        + rng.integers(-3, 4, (40, 48, 3)), 0, 255,
    ).astype(np.uint8)
    long_run = np.zeros((40, 48, 3), np.uint8)  # a 1919-pixel run: host fallback
    long_run[0, 0] = 7
    noise = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    imgs = [smooth, long_run, noise, smooth[::-1].copy()]
    cuda_ops.reset_launches()
    stats = {}
    out = nicetpu_torch.encode_batch(imgs, device="cuda", stats=stats)
    assert out == [oracle.encode_native(im) for im in imgs]
    assert stats == {"device": "cuda", "overflow_fallbacks": 1}
    assert all(n == 2 for n in cuda_ops.LAUNCHES.values())  # one batch per shape
