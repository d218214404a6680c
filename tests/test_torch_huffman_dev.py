"""PyTorch on-device Huffman tables (nicetpu_torch.kernels.huffman_dev) vs
the JAX device tables and the host tables, bit-exact.

All cases use batches of 3 so that JAX compiles `build_tables_device` once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.format import constants as C
from nicetpu.format.huffman import build_all_tables
from nicetpu.kernels import huffman_dev as jhd
from nicetpu_torch.kernels import huffman_dev as thd

from _huffman_rows import _deep, _random, _sparse


CASES = {"random": _random(0), "sparse": _sparse(1), "deep": _deep()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_tables_matches_jax_and_host(case):
    counts = CASES[case]
    jl, jc, jo = jhd.build_tables_device(jnp.asarray(counts.astype(np.int32)))
    tl, tc, to = thd.build_tables_device(torch.from_numpy(counts.astype(np.int32)))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy().view(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert not to.any()
    for b in range(3):
        ref_l, ref_c, _ = build_all_tables(counts[b])
        np.testing.assert_array_equal(tl[b].numpy(), ref_l)
        np.testing.assert_array_equal(tc[b].numpy().view(np.uint32), ref_c)


def test_deep_fixture_reaches_clamp_and_long_codes():
    """The fixture does what it claims: rows 0 and 2 hold deep codes with no
    clamp (31 bits on row 0); row 1 passes 31 bits before the clamp only."""
    counts = torch.from_numpy(_deep())
    raw = thd._merge_lengths(thd._counts_to_streams(counts)).amax(dim=-1)  # (3, 10)
    assert int(raw[0, C.SC_LUMA_OTHER_DIFF]) == C.MAX_CODE_LEN
    assert int(raw[0].max()) <= C.MAX_CODE_LEN
    assert int(raw[1, C.SC_LUMA_BASE_DIFF]) > C.MAX_CODE_LEN
    assert 15 < int(raw[2, C.SC_SMALL_DIFF]) <= C.MAX_CODE_LEN
    lengths, overflow = thd.code_lengths_device(counts)
    final = thd._counts_to_streams(lengths.to(torch.int64)).amax(dim=-1)
    assert torch.equal(final[[0, 2]], raw[[0, 2]])  # the clamp leaves them alone
    assert int(final.max()) <= C.MAX_CODE_LEN
    assert not overflow.any()


def test_canonical_codes_long_lengths():
    """Lengths 30 and 31, where the first-code scan leaves int32."""
    lengths = np.ones((3, C.TOTAL_SYMBOLS), np.int32)
    base = C.STREAM_BASE[C.SC_RGB]
    # a complete prefix code over stream 0: 1, 2, ..., 30, 31, 31
    lengths[:, base : base + 256] = 0
    lengths[:, base : base + 32] = np.concatenate([np.arange(1, 32), [31]])
    lengths[1, base : base + 32] = lengths[1, base : base + 32][::-1]
    jc = jhd.canonical_codes_device(jnp.asarray(lengths))
    tc = thd.canonical_codes_device(torch.from_numpy(lengths))
    np.testing.assert_array_equal(tc.numpy().view(np.uint32), np.asarray(jc))
