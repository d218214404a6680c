"""The port's decode core (`nicetpu_torch.kernels.decode3._decode_core_v3`)
against the JAX one on the same device arrays: `out`, `ok` and the four
gates [consistency, crossing, coverage, backref] are equal on the golden
`.nice` files.  `tests/test_torch_decode_gates.py` does the same on streams
built to trip each gate.  Integer arithmetic throughout: the comparison is
exact.  The JAX core's CPU compile is most of each case's time."""

import os

import numpy as np
import pytest
import torch

from nicetpu.kernels import decode3 as jd3
from nicetpu_torch.kernels import decode3 as td3

DATA = os.path.join(os.path.dirname(__file__), "data")


def _both(datas, *, chunk_bits=2048, steps_div=8, rounds=2):
    """Same-shape streams (or one) through the JAX core and the port's core,
    on the JAX package's own device arrays; returns the port's (out, ok,
    gates) after asserting that they equal JAX's."""
    datas = datas if isinstance(datas, list) else [datas]
    args, kw = jd3.prepare_batch_args(datas, chunk_bits=chunk_bits, steps_div=steps_div,
                                      rounds=rounds)
    want = jd3._device_decode_v3(*args, **kw)
    got = td3._decode_core_v3(
        *(torch.from_numpy(np.array(a)) for a in args), n_pixels=kw["n_pixels"],
        width=kw["width"], chunk_bits=kw["chunk_bits"], steps=kw["steps"], rounds=kw["rounds"],
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [g.numpy() for g in got]


@pytest.mark.parametrize("name", ["random8x6", "gradient16x12", "flat9x7", "mixed20x14"])
def test_decode_core_matches_jax_on_golden_files(name):
    img = np.load(os.path.join(DATA, f"{name}.npy"))
    with open(os.path.join(DATA, f"{name}.nice"), "rb") as f:
        data = f.read()
    out, ok, gates = _both(data)
    assert ok[0] and gates[0].all()
    h, w, _ = img.shape
    np.testing.assert_array_equal(out[0].reshape(3, h, w).transpose(1, 2, 0), img)
