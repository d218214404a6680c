"""The round trip of images of mixed shapes in shared device batches.

`api.roundtrip_batch` sorts a call's images by pixel count and cuts them
into batches of up to MAX_BATCH whatever their shapes; each batch is one
zero-padded upload with its `geometry.Geometry`, and every kernel of the
round trip works image by image at its own width and pixel count.  On the
CPU (the kernels' plain versions, tiny sizes): the bytes equal the
benchmark's frozen reference encoder's, the decoded planes equal each image
(zeros past it), `verified` holds, and the batch counters add up.  On the
card (marked `cuda`): the tokenizer, slot and reconstruction kernels with a
geometry table against their plain versions, and the round trip itself.
The file imports no JAX.
"""

import numpy as np
import pytest
import torch

import nicetpu_torch
from benchmark.reference import codec as reference
from nicetpu_torch import api, pipeline
from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels import cuda_ops, decode3, decode_dev, encode2, recon
from nicetpu_torch.kernels import tokenize as tok
from nicetpu_torch.kernels.geometry import COLS, Geometry

from _recon_rows import random_inputs as recon_random_inputs
from _slot_rows import records as slot_records


def _photo(h, w, seed):
    """Smooth content with a little noise: every rung-one gate passes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (120 + 40 * np.sin(xx / 9.0 + seed) + 30 * np.cos(yy / 5.0)).astype(np.int32)
    img = np.stack([base, base + 7, base - 9], axis=-1)
    return np.clip(img + rng.integers(-2, 3, img.shape), 0, 255).astype(np.uint8)


def _long_run(h, w):
    """One change, then a run of h * w - 1 pixels: more than 3 base-8
    digits, so the fused encode overflows and the host encodes it."""
    img = np.zeros((h, w, 3), np.uint8)
    img[0, 0] = 7
    return img


CASES = {
    "min_width": [(5, 4), (9, 4), (3, 4), (17, 6), (2, 5)],
    "odd_widths": [(7, 13), (11, 9), (5, 31), (13, 7), (3, 17)],
    "one_row": [(1, 40), (1, 9), (4, 12), (1, 64)],
    "eight_fold": [(16, 32), (4, 16), (8, 16), (2, 32)],
    "host_route": [(6, 15), "long", (3, 22), (9, 5)],
    "nine_alike": [(6, 10)] * 9 + [(3, 7), (12, 5)],
}


def _images(case):
    return [_long_run(6, 100) if s == "long" else _photo(*s, seed=k) for k, s in enumerate(CASES[case])]


def _counters(imgs):
    """device_batches, image_pixels, batch_pixels of the planner's rule:
    pixel counts largest first, cut into batches of MAX_BATCH."""
    n = sorted((im.shape[0] * im.shape[1] for im in imgs), reverse=True)
    cuts = [n[s : s + api.MAX_BATCH] for s in range(0, len(n), api.MAX_BATCH)]
    return {"device_batches": len(cuts), "image_pixels": sum(n), "batch_pixels": sum(len(c) * c[0] for c in cuts)}


def _planes(monkeypatch):
    """Every (B, 3, N) plane block a rung hands to `_equal_planar`."""
    seen, equal = [], decode3._equal_planar

    def capture(out, flat):
        seen.append(out.clone())
        return equal(out, flat)

    monkeypatch.setattr(decode3, "_equal_planar", capture)
    return seen


def _decoded(img, planes) -> bool:
    """Some captured row holds the image's pixels, then zeros."""
    n = img.shape[0] * img.shape[1]
    want = torch.from_numpy(img.reshape(n, 3).T.copy())
    return any(row.shape[1] >= n and torch.equal(row[:, :n], want) and not row[:, n:].any()
               for out in planes for row in out)


@pytest.mark.parametrize("case", list(CASES))
def test_mixed_shapes_round_trip_on_the_cpu(case, monkeypatch):
    imgs = _images(case)
    planes = _planes(monkeypatch)
    stats = {}
    datas, verified = nicetpu_torch.roundtrip_batch(imgs, device="cpu", stats=stats)
    assert datas == [reference.encode(im) for im in imgs]
    long_run = [isinstance(s, str) for s in CASES[case]]
    assert verified.tolist() == [not x for x in long_run]
    assert all(_decoded(im, planes) for im, v in zip(imgs, verified) if v)
    assert {k: stats[k] for k in api.BATCH_STATS} == _counters(imgs)
    assert stats["overflow_fallbacks"] == sum(long_run) and stats["fallbacks"] == 0


def test_same_shape_call_keeps_its_batches_and_bytes():
    """Ten images of one shape: the shape-keyed batches, in input order,
    the reference's bytes, and no padding."""
    imgs = [_photo(8, 12, seed=k) for k in range(10)]
    assert api.plan_batches(imgs, "cpu") == api._batches([im.shape for im in imgs]) == [list(range(8)), [8, 9]]
    stats = {}
    datas, verified = nicetpu_torch.roundtrip_batch(imgs, device="cpu", stats=stats)
    assert datas == [reference.encode(im) for im in imgs] and verified.all()
    assert stats["batch_pixels"] == stats["image_pixels"] == 10 * 96 and stats["device_batches"] == 2


def test_plan_is_largest_first_and_stable():
    shapes = [(2, 4), (3, 8), (6, 4), (2, 12)] + [(1, 4)] * 8
    imgs = [np.zeros((h, w, 3), np.uint8) for h, w in shapes]
    # 24, 24, 24 pixels keep their input order; then 8; then the 4s
    assert api.plan_batches(imgs, "cpu") == [[1, 2, 3, 0, 4, 5, 6, 7], [8, 9, 10, 11]]


def test_batch_refuses_a_width_below_the_minimum():
    imgs = [_photo(4, 8, 0), np.zeros((8, 3, 3), np.uint8)]
    with pytest.raises(ValueError, match="width"):
        nicetpu_torch.roundtrip_batch(imgs, device="cpu")


def test_geometry_rows_hold_each_images_maps():
    g = Geometry.of_shapes([(3, 4), (2, 10)], "cpu")
    assert g.table.shape == (2, COLS) and g.n_max == 20 and g.widths == (4, 10)
    assert g.table[:, :2].tolist() == [[4, 12], [10, 20]]
    # refoff's index table: 0, then the width's CONST offsets
    offs = [0] + decode_dev._const_offsets(10)
    assert g.table[1, 34 : 34 + len(offs)].tolist() == offs


def test_kernel_geometry_columns_match_the_source():
    import os

    src = open(os.path.join(os.path.dirname(cuda_ops.__file__), "..", "csrc", "common.cuh")).read()
    assert f"constexpr int kGeoCols = {COLS};" in src


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _upload(imgs):
    return pipeline.upload_batch(imgs, "cpu").contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [3, C.MAX_RUN_DIGITS])
def test_ragged_tokenize_matches_plain(dev, cap):
    """Widths 4 to 1,100 in one launch, a run across spans and past the
    3-digit cap, images that end inside and at the end of a span."""
    imgs = [_photo(9, 4, 1), _photo(7, 37, 2), _long_run(3, 1100), _photo(16, 64, 3), _photo(2, 1100, 4)]
    x = _upload(imgs)
    shapes = [im.shape[:2] for im in imgs]
    kw = dict(ndigits_cap=cap, invalid_bin=encode2.INVALID_BIN)
    want = tok.tokenize_images(x, geom=Geometry.of_shapes(shapes, "cpu"), **kw)
    before = cuda_ops.LAUNCHES["tokenize"]
    got = tok.tokenize_images(x.to(dev), geom=Geometry.of_shapes(shapes, dev), **kw)
    assert cuda_ops.LAUNCHES["tokenize"] == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert want[1].tolist() == [False, False, cap == 3, False, False]


@pytest.mark.cuda
def test_ragged_slot_assemble_matches_plain(dev):
    """Each image's own N, against the plain version and against each
    image assembled alone."""
    pos, sym, i12, i34, wbits, N = slot_records("walk", 4, 37, 256, seed=7)
    ns = [N, max(1, N // 2), 7, max(1, N // 3)]
    args = [torch.from_numpy(a) for a in (pos, sym, i12, i34, wbits)]
    want = cuda_ops.slot_assemble(*args, geom=Geometry([4] * 4, ns, "cpu"))
    got = cuda_ops.slot_assemble(*(a.to(dev) for a in args), geom=Geometry([4] * 4, ns, dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for b, n in enumerate(ns):
        alone = cuda_ops.slot_assemble(*(a[b : b + 1].to(dev) for a in args), n_pixels=n)
        k = alone[0].shape[1]
        for g, a in zip(got[:5], alone[:5]):
            assert torch.equal(g[b, :k].cpu(), a[0].cpu())
        assert bool(got[5][b]) == bool(alone[5][0])


def _ragged_recon_inputs(shapes, seed):
    """(form, delta, refoff) of each image, padded with noise to the
    largest image's pixels."""
    N = max(h * w for h, w in shapes)
    B = len(shapes)
    form = torch.randint(0, 5, (B, N), generator=torch.Generator().manual_seed(seed), dtype=torch.int32)
    delta = torch.randint(0, 256, (B, 3, N), generator=torch.Generator().manual_seed(seed + 1), dtype=torch.int32)
    refoff = torch.zeros(B, N, dtype=torch.int32)
    for b, (h, w) in enumerate(shapes):
        f, d, r = recon_random_inputs(1, h, w, seed=seed + b)
        form[b, : h * w], delta[b, :, : h * w], refoff[b, : h * w] = f[0], d[0], r[0]
    return form, delta, refoff


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [[(9, 4), (7, 20), (5, 37), (3, 512), (2, 1100)], [(2, 5000), (1, 8192)]],
                         ids=["one_block", "cluster"])
def test_ragged_reconstruct_rows_matches_plain(dev, shapes):
    form, delta, refoff = _ragged_recon_inputs(shapes, seed=len(shapes))
    want = recon.reconstruct_rows(form, delta, refoff, geom=Geometry.of_shapes(shapes, "cpu"))
    got = recon.reconstruct_rows(form.to(dev), delta.to(dev), refoff.to(dev),
                                 geom=Geometry.of_shapes(shapes, dev))
    assert torch.equal(got.cpu(), want)
    for b, (h, w) in enumerate(shapes):
        assert not want[b, :, h * w :].any()


@pytest.mark.cuda
def test_ragged_reconstruct_rows_refuses_two_paths(dev):
    shapes = [(2, 512), (1, 8192)]
    form, delta, refoff = (t.to(dev) for t in _ragged_recon_inputs(shapes, seed=3))
    with pytest.raises(ValueError, match="paths"):
        recon.reconstruct_rows(form, delta, refoff, geom=Geometry.of_shapes(shapes, dev))


@pytest.mark.cuda
def test_mixed_shapes_round_trip_on_the_card(dev):
    imgs = [_photo(h, w, seed=h * w) for h, w in [(40, 37), (128, 131), (9, 4), (77, 200), (1, 300)]]
    imgs += [_long_run(6, 100)] + [_photo(64, 96, seed=k) for k in range(9)]
    stats = {}
    datas, verified = nicetpu_torch.roundtrip_batch(imgs, device=dev, stats=stats)
    assert datas == [reference.encode(im) for im in imgs]
    assert verified.tolist() == [True] * 5 + [False] + [True] * 9
    assert {k: stats[k] for k in api.BATCH_STATS} == _counters(imgs)


def test_entry_point_signatures_match_the_sources():
    """Each ctypes signature of `build.SIGNATURES` has the C entry point's
    parameters, type by type (a pointer, an int, a long long)."""
    import ctypes
    import glob
    import os
    import re

    from nicetpu_torch.kernels import build

    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_longlong: "l"}
    src = "".join(open(p).read() for p in glob.glob(os.path.join(build.CSRC, "*.cu")))
    for name, argtypes in build.SIGNATURES.items():
        (params,) = re.findall(rf"\bint {name}\(([^)]*)\)", src)
        want = ["p" if "*" in p else "l" if "long long" in p else "i" for p in params.split(",")]
        assert [kinds[t] for t in argtypes] == want, name
