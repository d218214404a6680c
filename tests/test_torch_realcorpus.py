"""The port's real-photo corpus (`nicetpu_torch/data/realcorpus/`,
`nicetpu_torch.realcorpus`) against the JAX package's: each committed
`.nice` file equals the native encode of the JAX `load_corpus()` image,
`load_corpus(max_dim)` gives the same names, order and pixels.  The JAX
corpus reads the images from the Python packages that ship them (PIL);
exact comparisons throughout.  The fused round trip of real crops is held
to JAX's in `tests/test_torch_roundtrip.py`, at that file's shape."""

import functools

import numpy as np
import pytest

from nicetpu import realcorpus as jcorpus
from nicetpu.hostref import oracle as joracle
from nicetpu_torch import realcorpus as tcorpus


@functools.cache
def _jax_corpus() -> dict:
    return dict(jcorpus.load_corpus())


def test_the_corpus_names_follow_the_jax_module():
    assert tuple(_jax_corpus()) == tcorpus.NAMES


@pytest.mark.parametrize("name", tcorpus.NAMES)
def test_committed_file_equals_the_native_encode_of_the_jax_image(name):
    assert tcorpus.read_bytes(name) == joracle.encode_native(_jax_corpus()[name])


@pytest.mark.parametrize("max_dim", [None, 1024, 300])
def test_load_corpus_matches_jax(max_dim):
    want = jcorpus.load_corpus(max_dim=max_dim)
    got = tcorpus.load_corpus(max_dim=max_dim)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.dtype == np.uint8 and g.flags.c_contiguous, name
        np.testing.assert_array_equal(g, w, err_msg=name)
