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
from nicetpu_torch.kernels.geometry import Geometry

DATA = os.path.join(os.path.dirname(__file__), "data")


def _both(datas, *, chunk_bits=2048, steps_div=8, rounds=2):
    """Same-shape streams (or one) through the JAX core and the port's core,
    on the JAX package's own device arrays; returns the port's (out, ok,
    gates) after asserting that they equal JAX's."""
    datas = datas if isinstance(datas, list) else [datas]
    args, kw = jd3.prepare_batch_args(datas, chunk_bits=chunk_bits, steps_div=steps_div,
                                      rounds=rounds)
    want = jd3._device_decode_v3(*args, **kw)
    geom = Geometry.uniform(kw["width"], kw["n_pixels"], len(datas), "cpu")
    got = td3._decode_core_v3(
        *(torch.from_numpy(np.array(a)) for a in args), geom=geom,
        chunk_bits=kw["chunk_bits"], steps=kw["steps"], rounds=kw["rounds"],
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


@pytest.mark.parametrize("name", ["gradient16x12", "mixed20x14"])
def test_decode_core_with_the_walk_tables_given(name):
    """The walk's tables built with the rest in one call
    (`prepare_tables_v3(walk=True)`, as every decode path builds them once a
    batch) and handed to the core give what the core gives when it derives
    them itself, and what JAX's core gives."""
    with open(os.path.join(DATA, f"{name}.nice"), "rb") as f:
        data = f.read()
    want = _both(data)  # the port's core without walk_tables, held to JAX's
    args, walk, (h, w) = td3._batch_args([data], device=torch.device("cpu"), ladder=(td3.WalkCfg(2048, 32, 8, 2),))
    assert all(torch.equal(g, x) for g, x in zip(walk, td3.derive_walk_tables_plain(*args[2:5])))
    got = td3._decode_core_v3(*args, geom=Geometry.uniform(w, h * w, 1, "cpu"), chunk_bits=2048, steps=td3._steps(2048, 8),
                              rounds=2, walk_tables=walk)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), x)
