"""The frozen reference against the program's host codec (this test may
import the program; the reference may not)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import corpus, jobs
from benchmark.reference import codec

from _tiny import REPO


def _images():
    rng = np.random.default_rng(7)
    px = corpus.load(REPO, ["wood", "soccer0"])
    yield "noise", rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    yield "flat_runs", np.repeat((rng.integers(0, 3, (6, 1, 3)) * 90).astype(np.uint8), 700, axis=1)
    yield "wood", np.ascontiguousarray(px["wood"][100:148, 200:264])
    yield "soccer0", np.ascontiguousarray(px["soccer0"][:40, :2048])


@pytest.mark.parametrize("name,img", list(_images()), ids=lambda x: x if isinstance(x, str) else "")
def test_reference_bytes_equal_hostref(name, img):
    from nicetpu_torch.hostref import oracle

    data = codec.encode(img)
    assert data == oracle.encode_native(img)
    assert np.array_equal(codec.decode(data), img)


def test_reference_in_subprocesses_drops_alpha():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (5, 8, 4), dtype=np.uint8) for _ in range(3)]
    out = jobs.encode(imgs, REPO, procs=2)
    assert out == [codec.encode(np.ascontiguousarray(im[:, :, :3])) for im in imgs]
