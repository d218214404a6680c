"""The port's fused encode (nicetpu_torch) vs the JAX fused encode and the
spec codec: payload words, the (B, 860) small array and `.nice` bytes are
bit-exact."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.format import constants as C
from nicetpu.kernels import encode2 as jenc
from nicetpu.kernels.huffman_dev import build_tables_device as jax_tables
from nicetpu.pipeline import _w_cap
from nicetpu.spec import codec
import nicetpu_torch
from nicetpu_torch import convert, pipeline
from nicetpu_torch.kernels import cuda_ops
from nicetpu_torch.kernels import encode2 as tenc
from nicetpu_torch.kernels.geometry import Geometry

H, W = 12, 16


def _batch(seed=3, B=3):
    """Smooth images with small noise plus a flat band (runs)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for _ in range(B):
        ph = rng.uniform(0, 6)
        base = 120 + 40 * np.sin(xx / 3.0 + ph) + 30 * np.cos(yy / 2.0)
        img = np.clip(base[..., None] + rng.integers(-2, 3, (H, W, 3)), 0, 255)
        img = img.astype(np.uint8)
        img[5:7] = img[5, 0]
        out.append(img)
    return np.stack(out)


def _long_run_image():
    img = np.zeros((24, 32, 3), np.uint8)  # a 767-pixel run needs 4 digits
    img[0, 0] = 3
    return img


def test_encode_fused_matches_jax():
    imgs = _batch()
    B = imgs.shape[0]
    flat = imgs.reshape(B, H * W, 3)
    w_cap = _w_cap(H * W)
    jw, js = jenc.encode_fused(jnp.asarray(flat), width=W, ndigits_cap=3, w_cap=w_cap)
    tw, ts = tenc.encode_fused(torch.from_numpy(flat), geom=Geometry.uniform(W, H * W, B, "cpu"), ndigits_cap=3,
                               w_cap=w_cap)
    assert ts.shape == (B, 860)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(convert.words_to_numpy(tw), np.asarray(jw))
    assert not ts[:, 859].any()


def test_join_and_fold_stages_on_jax_tables():
    """JAX's bins and tables, handed over with `convert`, go through the
    port's join and fold + place; each stage equals JAX's own."""
    imgs = _batch(seed=4)
    B = imgs.shape[0]
    flat = jnp.asarray(imgs.reshape(B, H * W, 3))
    bins, _ = jax.vmap(partial(jenc._tokenize_core, width=W, ndigits_cap=3))(flat)
    counts = np.stack([np.bincount(b[b < C.TOTAL_SYMBOLS], minlength=C.TOTAL_SYMBOLS)
                       for b in np.asarray(bins)])
    lengths, codes, _ = jax_tables(jnp.asarray(counts.astype(np.int32)))
    lt, ct = convert.tables_from_numpy(np.asarray(lengths), np.asarray(codes), "cpu")
    tbins = torch.from_numpy(np.array(bins))

    aob, code = cuda_ops.table_join(tbins, lt, ct)
    live = np.asarray(bins) < C.TOTAL_SYMBOLS
    bi = np.where(live, np.asarray(bins), 0)
    want_aob = np.where(live, np.take_along_axis(np.asarray(lengths), bi, 1), 0)
    want_code = np.where(live, np.take_along_axis(np.asarray(codes), bi, 1), 0)
    np.testing.assert_array_equal(aob.numpy(), want_aob)
    np.testing.assert_array_equal(code.numpy().view(np.uint32), want_code)

    w_cap = _w_cap(H * W)
    slots = aob.shape[1] // (H * W)
    words, totals, ovf = tenc._fold_place_grouped_batched(
        aob.view(B, -1, slots), code.view(B, -1, slots), w_cap=w_cap
    )
    jw, jt, jo = jax.vmap(partial(jenc._fold_place_grouped, w_cap=w_cap))(
        jnp.asarray(want_aob.reshape(B, -1, slots)),
        jnp.asarray(want_code.reshape(B, -1, slots).astype(np.uint32)),
    )
    np.testing.assert_array_equal(convert.words_to_numpy(words), np.asarray(jw))
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jo))


def test_encode_batch_cpu_matches_spec_with_counted_fallback():
    imgs = list(_batch(seed=5)) + [_long_run_image(), (_batch(seed=6, B=1)[0][:9, :7]).copy()]
    stats = {}
    out = nicetpu_torch.encode_batch(imgs, device="cpu", stats=stats)
    assert [d == codec.encode(im) for d, im in zip(out, imgs)] == [True] * len(imgs)
    # api.encode_batch takes the two-step encode, which keeps the long-run
    # image on the device (tokenized again with 11 run digits): no fallback
    assert stats == {"device": "cpu", "overflow_fallbacks": 0, "retokenized": 1, "slot_mode": 0}
    assert nicetpu_torch.encode(imgs[0], device="cpu") == out[0]


def test_encode_batch_fused_flags_only_the_long_run():
    """The long-run image sets its overflow flag and is served by the host
    encoder; its neighbours in the same batch take the device path."""
    img = _long_run_image()
    other = (np.random.default_rng(8).integers(0, 4, img.shape) * 50).astype(np.uint8)
    stats = {}
    out = pipeline.encode_batch_fused([img, other], device=torch.device("cpu"), stats=stats)
    assert out == [codec.encode(img), codec.encode(other)]
    assert stats["overflow_fallbacks"] == 1


def test_small_w_cap_sets_the_flag_and_falls_back(monkeypatch):
    """A payload over the word capacity sets the overflow flag of that image
    only, and the pipeline serves it from the host encoder, counted."""
    flat_img = np.full((H, W, 3), 90, np.uint8)
    noisy = np.random.default_rng(10).integers(0, 256, (H, W, 3)).astype(np.uint8)
    small_cap = 16  # 448 payload bits: room for the flat image only
    batch = torch.from_numpy(np.stack([flat_img, noisy]).reshape(2, H * W, 3))
    _, small = tenc.encode_fused(batch, geom=Geometry.uniform(W, H * W, 2, "cpu"), ndigits_cap=3, w_cap=small_cap)
    assert small[:, 859].tolist() == [0, 1]
    monkeypatch.setattr(pipeline, "w_cap", lambda n: small_cap)
    stats = {}
    out = pipeline.encode_batch_fused([flat_img, noisy], device=torch.device("cpu"), stats=stats)
    assert out == [codec.encode(flat_img), codec.encode(noisy)]
    assert stats["overflow_fallbacks"] == 1


def test_total_bits_of_2_pow_31_overflow():
    """A total that does not fit the int32 slot of `small` is flagged even
    where the word capacity would hold it."""
    totals = torch.tensor([0, 2**31 - 1, 2**31, 2**32 + 5], dtype=torch.int64)
    assert tenc.total_bits_overflow(totals).tolist() == [False, False, True, True]


def test_cuda_request_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nicetpu_torch.encode_batch([_batch(B=1)[0]], device="cuda")
    with pytest.raises(ValueError):
        nicetpu_torch.encode(_batch(B=1)[0], device="meta")


def test_convert_roundtrip():
    rng = np.random.default_rng(9)
    lengths = rng.integers(0, 32, (2, C.TOTAL_SYMBOLS)).astype(np.int32)
    codes = rng.integers(0, 2**32, (2, C.TOTAL_SYMBOLS), dtype=np.uint64).astype(np.uint32)
    lt, ct = convert.tables_from_numpy(lengths, codes, "cpu")
    assert lt.dtype == ct.dtype == torch.int32
    np.testing.assert_array_equal(lt.numpy(), lengths)
    np.testing.assert_array_equal(convert.words_to_numpy(ct), codes)
