"""The port's decode core against the JAX one on streams built to trip
each gate [consistency, crossing, coverage, backref] (the classes of
`tests/test_corruption_gates.py`): `out`, `ok` and the gates are equal, and
the expected gate is the one that fails.  Exact comparisons."""

import numpy as np

from nicetpu.format import constants as C
from nicetpu.format import headers, huffman
from nicetpu.spec import codec

from test_torch_decode_core import _both

CONSISTENCY, CROSSING, COVERAGE, BACKREF = range(4)


def _abab(h, w):
    img = np.zeros((h, w, 3), np.uint8)
    img[:, 0::2] = (200, 10, 40)
    img[:, 1::2] = (15, 220, 90)
    return img


def test_truncation_trips_coverage_and_short_groups_trip_crossing_alike():
    """One batch of two 48 x 48 streams (one compile): a payload cut in half
    under-covers the raster; 2-bit groups exhaust the step budget."""
    rng = np.random.default_rng(1)
    data = codec.encode((rng.integers(0, 25, (48, 48, 3)) * 9).astype(np.uint8))
    cut = (len(data) - C.FILE_HEADER_BYTES - C.STREAM_HEADERS_BYTES) // 2
    _, ok, gates = _both([data[: len(data) - cut], codec.encode(_abab(48, 48))])
    assert not ok.any()
    assert not gates[0, COVERAGE] and not gates[1, CROSSING]


def test_invalid_backref_index_trips_backref_alike():
    img = _abab(32, 32)
    plan = codec.tokenize(img)
    idx = np.argwhere((plan.streams == C.SC_BACK_REF) & plan.valid)
    r, c = idx[len(idx) // 2]
    plan.symbols[r, c] = 9  # a back-ref index with no offset
    lengths, codes, _ = huffman.build_all_tables(codec.histogram(plan))
    data = (headers.pack_file_header(32, 32, 3) + headers.pack_stream_headers(lengths)
            + codec.pack_payload(plan, lengths, codes))
    _, ok, gates = _both(data, steps_div=3, rounds=3)
    assert not ok[0] and not gates[0, BACKREF]


def test_self_sync_miss_trips_consistency_alike():
    """Uniform noise at 512-bit chunks: the speculative entries do not
    synchronise and the consistency gate catches it."""
    rng = np.random.default_rng(0)
    data = codec.encode(rng.integers(0, 256, (48, 48, 3)).astype(np.uint8))
    _, ok, gates = _both(data, chunk_bits=512, steps_div=3, rounds=2)
    assert not ok[0] and not gates[0, CONSISTENCY]
