"""Kernel wrappers of nicetpu_torch.kernels.cuda_ops.

The plain PyTorch versions are held bit-exactly against the Pallas kernels
run in interpret mode, on the fixtures of test_pallas_interpret.py.  The
CUDA kernels themselves are held against the plain versions on a GPU by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.format import constants as C
from nicetpu.kernels.encode2 import _fold_pixel_records
from nicetpu.kernels.pallas_ops import (
    BINS_PAD,
    fold_records_pallas,
    histogram_pallas,
    table_join_pallas,
)
from nicetpu_torch.kernels import cuda_ops


def _rand_bins(B, M, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, C.TOTAL_SYMBOLS, (B, M)).astype(np.int32)
    bins[rng.random((B, M)) < 0.3] = BINS_PAD - 1
    return bins


def _rand_tables(B, seed=1):
    rng = np.random.default_rng(seed)
    aob = rng.integers(1, 32, (B, C.TOTAL_SYMBOLS)).astype(np.int32)
    code = rng.integers(0, 2**32, (B, C.TOTAL_SYMBOLS), dtype=np.uint64).astype(np.uint32)
    return aob, code


def _rand_fold(B, M, S, seed=5, full_codes=False):
    """Group slots as in test_pallas_interpret: lengths < 32 with 40 %
    holes; codes masked to their length, or any 32-bit pattern."""
    rng = np.random.default_rng(seed)
    aob = rng.integers(0, 32, (B, M, S)).astype(np.int32)
    aob[rng.random((B, M, S)) < 0.4] = 0
    if full_codes:
        code = rng.integers(0, 2**32, (B, M, S), dtype=np.uint64)
    else:
        code = rng.integers(0, 2**31, (B, M, S)) & ((1 << np.maximum(aob, 1)) - 1)
    return aob, code.astype(np.uint32).view(np.int32)


def test_histogram_plain_vs_pallas():
    bins = _rand_bins(2, 5000)
    want = histogram_pallas(jnp.asarray(bins), interpret=True)
    got = cuda_ops.histogram_plain(torch.from_numpy(bins))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_table_join_plain_vs_pallas():
    bins = _rand_bins(2, 4096, seed=2)
    aob_tbl, code_tbl = _rand_tables(2)
    aob_w, code_w = table_join_pallas(
        jnp.asarray(bins), jnp.asarray(aob_tbl), jnp.asarray(code_tbl), interpret=True
    )
    aob, code = cuda_ops.table_join_plain(
        torch.from_numpy(bins), torch.from_numpy(aob_tbl),
        torch.from_numpy(code_tbl.view(np.int32)),
    )
    np.testing.assert_array_equal(aob.numpy(), np.asarray(aob_w))
    np.testing.assert_array_equal(code.numpy().view(np.uint32), np.asarray(code_w))


def test_fold_records_plain_vs_pallas():
    B, M, S, capw = 2, 64, 16, cuda_ops.FOLD_CAPW
    aob, code = _rand_fold(B, M, S)
    rec_w, k_w = fold_records_pallas(jnp.asarray(aob), jnp.asarray(code), capw=capw, interpret=True)
    rec, k = cuda_ops.fold_records_plain(torch.from_numpy(aob), torch.from_numpy(code))
    # the Pallas kernel pads groups to 1024; the port has no padded groups
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_w)[:, :M])
    np.testing.assert_array_equal(rec.numpy(), np.asarray(rec_w)[:, :, :M])


def test_fold_records_plain_full_codes_vs_jnp_twin():
    """Any 32-bit code pattern (MSB set, bits above the length): the plain
    fold still equals the JAX jnp fold, which shares the Pallas math."""
    B, M, S, capw = 2, 32, 64, cuda_ops.FOLD_CAPW
    aob, code = _rand_fold(B, M, S, seed=6, full_codes=True)
    rec_w, k_w = jax.vmap(
        lambda a, c: (lambda r, kk: (jnp.stack(r, 0), kk))(
            *_fold_pixel_records(a, jax.lax.bitcast_convert_type(c, jnp.uint32), capw)
        )
    )(jnp.asarray(aob), jnp.asarray(code))
    rec, k = cuda_ops.fold_records_plain(torch.from_numpy(aob), torch.from_numpy(code))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_w))
    np.testing.assert_array_equal(rec.numpy().view(np.uint32), np.asarray(rec_w))


def test_wrappers_on_cpu_run_plain_and_launch_nothing():
    cuda_ops.reset_launches()
    bins = torch.from_numpy(_rand_bins(2, 1000, seed=3))
    aob_tbl, code_tbl = _rand_tables(2)
    lt, ct = torch.from_numpy(aob_tbl), torch.from_numpy(code_tbl.view(np.int32))
    assert torch.equal(cuda_ops.histogram(bins), cuda_ops.histogram_plain(bins))
    for got, want in zip(cuda_ops.table_join(bins, lt, ct), cuda_ops.table_join_plain(bins, lt, ct)):
        assert torch.equal(got, want)
    a, c = (torch.from_numpy(x) for x in _rand_fold(2, 16, 64))
    for got, want in zip(cuda_ops.fold_records(a, c), cuda_ops.fold_records_plain(a, c)):
        assert torch.equal(got, want)
    assert all(n == 0 for n in cuda_ops.LAUNCHES.values())


@pytest.mark.parametrize(
    "call",
    [
        lambda: cuda_ops.histogram(torch.zeros(2, 8, dtype=torch.int64)),
        lambda: cuda_ops.histogram(torch.zeros(16, dtype=torch.int32)),
        lambda: cuda_ops.histogram(torch.zeros(8, 2, dtype=torch.int32).t()),
        lambda: cuda_ops.histogram(torch.zeros(2, 0, dtype=torch.int32)),
        lambda: cuda_ops.table_join(
            torch.zeros(2, 8, dtype=torch.int32),
            torch.zeros(2, 857, dtype=torch.int32),
            torch.zeros(2, 858, dtype=torch.int32),
        ),
        lambda: cuda_ops.fold_records(
            torch.zeros(1, 4, 64, dtype=torch.int32), torch.zeros(1, 4, 32, dtype=torch.int32)
        ),
        lambda: cuda_ops.fold_records(
            torch.zeros(1, 4, 64, dtype=torch.int32), torch.zeros(1, 4, 64, dtype=torch.float32)
        ),
    ],
)
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()
