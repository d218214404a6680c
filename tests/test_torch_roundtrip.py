"""The port's fused round trip and decode from bytes against the JAX
package: `roundtrip_verify_fused`'s words, (B, 862) small2 and `verified`
equal JAX's on one batch (two smooth images that verify on the fast rung
and one noise image over a 17 bits/pixel word cap), and the entry points
round-trip and decode on the CPU, with the robust rung's retry and the
host path counted.  Exact comparisons throughout."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.hostref import oracle as joracle
from nicetpu.kernels import decode3 as jd3
import nicetpu_torch
from nicetpu_torch import convert, realcorpus
from nicetpu_torch.kernels import decode3 as td3
from nicetpu_torch.kernels.geometry import Geometry

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = ["random8x6", "gradient16x12", "flat9x7", "mixed20x14"]
H, W = 16, 128


def _batch():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for b in range(2):  # the images of tests/test_fused_roundtrip.py
        base = (120 + 40 * np.sin(xx / 9.0 + b) + 30 * np.cos(yy / 5.0)).astype(np.int32)
        img = np.stack([base, base + 7, base - 9], axis=-1)
        out.append(np.clip(img + rng.integers(-2, 3, img.shape), 0, 255).astype(np.uint8))
    out.append(rng.integers(0, 256, (H, W, 3)).astype(np.uint8))  # about 25 bits/pixel
    abab = np.zeros((H, W, 3), np.uint8)  # every pixel a BACK_REF: 2-bit groups
    abab[:, 0::2] = (200, 10, 40)
    abab[:, 1::2] = (15, 220, 90)
    out.append(abab)
    return out


IMGS = _batch()
FLAT = np.stack([im.reshape(H * W, 3) for im in IMGS[:3]])
W_CAP = H * W * 17 // 32 + 64  # the noise image's payload does not fit
GEOM = Geometry.uniform(W, H * W, len(FLAT), "cpu")  # the batch's three images


def test_fused_core_matches_jax():
    w_cap = W_CAP
    jw, js = jd3._roundtrip_fused_jit(
        jnp.asarray(FLAT), width=W, ndigits_cap=3, w_cap=w_cap, cfg=jd3.LADDER[0],
        maxl=jd3.FUSED_MAXL, segs=jd3._segs_for(W),
    )
    tw, ts = td3._roundtrip_verify_core(torch.from_numpy(FLAT), geom=GEOM, ndigits_cap=3,
                                        w_cap=w_cap, cfg=td3.LADDER[0])
    np.testing.assert_array_equal(convert.words_to_numpy(tw), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # [lengths, total, ovf, verified_ok, eq]: the smooth pair verifies on the
    # fast rung, the noise overflows the cap
    assert ts[:, 859].tolist() == [0, 0, 1]
    assert ts[:, 860].tolist() == [1, 1, 0]


def test_roundtrip_verify_fused_matches_jax():
    jstats, tstats = {}, {}
    jw, jsmall, jver = jd3.roundtrip_verify_fused(jnp.asarray(FLAT), width=W, w_cap=W_CAP,
                                                  stats=jstats)
    tw, tsmall, tver = td3.roundtrip_verify_fused(torch.from_numpy(FLAT), geom=GEOM, w_cap=W_CAP,
                                                  stats=tstats)
    np.testing.assert_array_equal(convert.words_to_numpy(tw), np.asarray(jw))
    np.testing.assert_array_equal(tsmall, np.asarray(jsmall))
    np.testing.assert_array_equal(tver, jver)
    assert tver.tolist() == [True, True, False]
    assert tstats == jstats == {"retries": 0, "fallbacks": 1, "ok": [True, True, False]}


def test_real_crops_round_trip_alike():
    """Real-photo crops at the batch's shape, rows 64..79 of each image:
    soccer0 (mostly run digits) and marble miss on the fast rung and verify
    on the robust one; camera_hsv overflows the word cap and is never
    verified.  Words, small, verified and stats equal JAX's."""
    corpus = dict(realcorpus.load_corpus())
    flat = np.stack([corpus[n][64 : 64 + H, :W].reshape(H * W, 3) for n in ("soccer0", "marble", "camera_hsv")])
    jstats, tstats = {}, {}
    jw, jsmall, jver = jd3.roundtrip_verify_fused(jnp.asarray(flat), width=W, w_cap=W_CAP, stats=jstats)
    tw, tsmall, tver = td3.roundtrip_verify_fused(torch.from_numpy(flat), geom=GEOM, w_cap=W_CAP, stats=tstats)
    np.testing.assert_array_equal(convert.words_to_numpy(tw), np.asarray(jw))
    np.testing.assert_array_equal(tsmall, np.asarray(jsmall))
    np.testing.assert_array_equal(tver, jver)
    assert tver.tolist() == [True, True, False] and tsmall[:, 859].tolist() == [0, 0, 1]
    assert tstats == jstats == {"retries": 2, "fallbacks": 1, "ok": [True, True, False]}


def test_roundtrip_batch_entry_point_on_the_cpu():
    """At the default 16 bits/pixel cap (plus 1024 words) the noise image
    fits, misses on the fast rung and verifies on the robust one; the 2-bit
    groups run out of steps on both rungs and are proven on the host; a long
    run needs 4 base-8 digits and is encoded by the host codec."""
    long_run = np.zeros((H, W, 3), np.uint8)
    long_run[0, 0] = 7
    imgs = IMGS + [long_run]
    stats = {}
    datas, verified = nicetpu_torch.roundtrip_batch(imgs, device="cpu", stats=stats)
    assert datas == [joracle.encode_native(im) for im in imgs]
    assert verified.tolist() == [True, True, True, False, False]
    # one device batch of the five same-shape images, no padding
    assert stats == {"device": "cpu", "retries": 2, "fallbacks": 1, "overflow_fallbacks": 1,
                     "overflow_decoded": 1, "device_batches": 1, "image_pixels": 5 * H * W,
                     "batch_pixels": 5 * H * W}


def _golden():
    imgs, datas = [], []
    for name in GOLDEN:
        imgs.append(np.load(os.path.join(DATA, f"{name}.npy")))
        with open(os.path.join(DATA, f"{name}.nice"), "rb") as f:
            datas.append(f.read())
    return imgs, datas


def test_decode_batch_on_golden_files():
    imgs, datas = _golden()
    stats = {}
    out = nicetpu_torch.decode_batch(datas + datas[:1], device="cpu", stats=stats)
    for o, im in zip(out, imgs + imgs[:1]):
        np.testing.assert_array_equal(o, im)
    assert stats == {"device": "cpu", "retries": 0, "fallbacks": 0}
    np.testing.assert_array_equal(nicetpu_torch.decode(datas[3], device="cpu"), imgs[3])


def test_decode_batch_honours_an_explicit_chunk_size(monkeypatch):
    imgs, datas = _golden()
    seen = []
    core = td3._decode_core_v3

    def spy(*args, **kw):
        seen.append(kw["chunk_bits"])
        return core(*args, **kw)

    monkeypatch.setattr(td3, "_decode_core_v3", spy)
    out = nicetpu_torch.decode_batch(datas[:2], device="cpu", chunk_bits=512)
    for o, im in zip(out, imgs):
        np.testing.assert_array_equal(o, im)
    assert seen and set(seen) == {512}


def test_decode_falls_back_to_the_host_on_an_unverifiable_stream():
    data = joracle.encode_native(IMGS[3])  # 2-bit groups: no rung has the steps
    stats = {}
    out = nicetpu_torch.decode_batch([data], device="cpu", stats=stats)
    np.testing.assert_array_equal(out[0], IMGS[3])
    assert stats == {"device": "cpu", "retries": 2, "fallbacks": 1}


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default runs there")
    _, datas = _golden()
    for call in (lambda: nicetpu_torch.decode(datas[0]), lambda: nicetpu_torch.encode(IMGS[0]),
                 lambda: nicetpu_torch.roundtrip_batch(IMGS[:1]),
                 lambda: nicetpu_torch.decode_batch(datas)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_run_ladder_matches_jax():
    """The retry ladder merges per-image results rung by rung and counts
    retries and fallbacks as the JAX one does (a scripted call per rung)."""
    oks = [np.array([True, False, False, False]), np.array([False, True, False, True])]
    vals = [np.arange(4) * 10, np.arange(4) * 100]
    gates = [np.ones((4, 4), bool), np.zeros((4, 4), bool)]

    def call(rung):
        return oks[rung], (vals[rung].copy(),), gates[rung]

    skip = np.array([False, False, False, True])
    for ladder, sk in (((0, 1), None), ((0, 1), skip), ((0,), None)):
        js, ts = {}, {}
        jok, jaux = jd3.run_ladder(call, 4, ladder=ladder, skip=sk, stats=js)
        tok, taux = td3.run_ladder(call, 4, ladder=ladder, skip=sk, stats=ts)
        np.testing.assert_array_equal(tok, jok)
        np.testing.assert_array_equal(taux[0], jaux[0])
        assert ts == js
