"""The port's two-step encode (`nicetpu_torch.kernels.encode2`:
`tokenize_compact`, `pack_compact`, `_place`, `encode_batch`; `api.encode`
and `api.encode_batch` on a device) against the JAX two-step encode and
`hostref`, bit for bit on the CPU.

Three shapes, one module-scoped fixture each, so that JAX compiles its
two-step encode once a shape:
  three   the three 12x16 images of `tests/test_batch.py` (noise, quantized,
          flat);
  longrun a (2, 4, 200) batch whose first image is one flat 800-pixel run:
          more than 3 run digits, so the whole batch is tokenized again
          with 11;
  deep    one 1x4096 row whose residuals are six values with Fibonacci
          weights, save one group of 8 pixels with residuals seen nowhere
          else: their 16-17-bit codes make a group record of 336 bits, so
          the fold flags it and the batch is packed slot by slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.format.huffman import build_tables_host as jax_tables
from nicetpu.kernels import encode2 as jenc
import nicetpu_torch
from nicetpu_torch import convert
from nicetpu_torch.config import RuntimeConfig
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import encode2 as tenc


def _three():
    rng = np.random.default_rng(1)
    return np.stack([
        rng.integers(0, 256, (12, 16, 3), dtype=np.uint8),
        (rng.integers(0, 4, (12, 16, 1)) * 60 + rng.integers(0, 4, (12, 16, 3))).astype(np.uint8),
        np.full((12, 16, 3), 9, dtype=np.uint8),
    ])


def _longrun():
    rng = np.random.default_rng(2)
    out = np.zeros((2, 4, 200, 3), np.uint8)
    out[0] = 77  # one flat 800-pixel run
    xx = np.arange(200)[None, :, None]
    out[1] = np.clip(120 + 40 * np.sin(xx / 9.0) + rng.integers(-3, 4, (4, 200, 3)), 0, 255)
    return out


def _deep():
    rng = np.random.default_rng(0)
    fib = np.array([1.0, 1, 2, 3, 5, 8])[::-1]
    d = rng.choice(40 + 12 * np.arange(6), (4096, 3), p=fib / fib.sum())
    d[2048:2056] = rng.integers(0, 128, (8, 3)) * 2 + 1  # residuals seen nowhere else
    return (np.cumsum(d, axis=0) % 256).astype(np.uint8)[None, None]


SHAPES = {"three": _three, "longrun": _longrun, "deep": _deep}
# what the port's encode_batch counts on each shape
WANT_STATS = {"three": {}, "longrun": {"retokenized": 2}, "deep": {"slot_mode": 1}}


@pytest.fixture(scope="module")
def jax_runs():
    """Each shape's images and the JAX two-step encode's bytes (which also
    compiles the JAX tokenize_compact and pack_compact the tests reuse)."""
    out = {}
    for name, make in SHAPES.items():
        imgs = make()
        out[name] = (imgs, jenc.encode_batch(imgs))
    return out


def _flat(imgs):
    B, H, W, _ = imgs.shape
    return imgs.reshape(B, H * W, 3), W


@pytest.mark.parametrize("name,cap", [("three", 3), ("longrun", 3), ("longrun", 11), ("deep", 3)])
def test_tokenize_compact_matches_jax(jax_runs, name, cap):
    flat, W = _flat(jax_runs[name][0])
    jb, js = jenc.tokenize_compact(jnp.asarray(flat), width=W, ndigits_cap=cap)
    tb, ts = tenc.tokenize_compact(torch.from_numpy(flat), width=W, ndigits_cap=cap)
    assert ts.shape == (flat.shape[0], 859) and tb.dtype == ts.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert bool(ts[:, -1].any()) == (name == "longrun" and cap == 3)


@pytest.mark.parametrize("name,cap,mode", [("longrun", 11, "fold"), ("longrun", 11, "slots"),
                                           ("deep", 3, "fold"), ("deep", 3, "slots")])
def test_pack_compact_matches_jax(jax_runs, name, cap, mode):
    """JAX's bins and the JAX package's host tables through both packs: the
    words, totals and overflow flags are equal."""
    flat, W = _flat(jax_runs[name][0])
    N = flat.shape[1]
    jb, js = jenc.tokenize_compact(jnp.asarray(flat), width=W, ndigits_cap=cap)
    counts = np.asarray(js)[:, :-1].astype(np.int64)
    tables = [jax_tables(c) for c in counts]
    lengths = np.stack([t[0] for t in tables]).astype(np.int32)
    codes = np.stack([t[1] for t in tables])
    w_cap = tenc.payload_capacity((counts * lengths).sum(axis=1), N)
    slots = jb.shape[1] // N
    # mode is passed as JAX's encode_batch passes it (the default for the
    # fold), so that its compiled packs are reused
    kw = {"mode": mode} if mode == "slots" else {}
    jw, jt, jo = jenc.pack_compact(jb, jnp.asarray(lengths), jnp.asarray(codes), w_cap=w_cap,
                                   slots=slots, **kw)
    lt, ct = convert.tables_from_numpy(lengths, codes, "cpu")
    tw, tt, to = tenc.pack_compact(torch.from_numpy(np.array(jb)), lt, ct, w_cap=w_cap, slots=slots,
                                   mode=mode)
    np.testing.assert_array_equal(convert.words_to_numpy(tw), np.asarray(jw))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert bool(to.any()) == (name == "deep" and mode == "fold")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_encode_batch_matches_jax_and_hostref(jax_runs, name):
    imgs, jax_out = jax_runs[name]
    stats = {}
    out = tenc.encode_batch(imgs, device="cpu", stats=stats)
    assert out == jax_out == [oracle.encode_native(im) for im in imgs]
    assert stats == WANT_STATS[name]
    assert tenc.encode_v2(imgs[-1], device="cpu") == out[-1]


def _bit_writer(aob, code):
    """The payload words of (aob, code) slots written one bit at a time."""
    bits = [(int(c) >> (n - 1 - i)) & 1 for n, c in zip(aob, code) for i in range(int(n))]
    bits += [0] * (-len(bits) % 32)
    return [int("".join(map(str, bits[i : i + 32])), 2) for i in range(0, len(bits), 32)], sum(map(int, aob))


@pytest.mark.parametrize("block", [7, 1 << 26])
def test_place_equals_a_bit_writer(monkeypatch, block):
    """`_place` on random lengths 0..31 (holes among them) equals writing the
    codes one bit at a time, in one pass and in blocks of 7 slots; words
    past w_cap are dropped."""
    monkeypatch.setattr(tenc, "PLACE_BLOCK", block)
    rng = np.random.default_rng(block)
    aob = rng.integers(0, 32, 600).astype(np.int32)
    aob[rng.random(600) < 0.3] = 0
    code = (rng.integers(0, 2**32, 600, dtype=np.uint64) & ((1 << aob.astype(np.uint64)) - 1)).astype(np.uint32)
    want, total = _bit_writer(aob, code)
    words, got_total = tenc._place(torch.from_numpy(aob), torch.from_numpy(code.view(np.int32)),
                                   w_cap=len(want) + 3)
    assert int(got_total) == total
    assert convert.words_to_numpy(words).tolist() == want + [0, 0, 0]
    short, _ = tenc._place(torch.from_numpy(aob), torch.from_numpy(code.view(np.int32)), w_cap=5)
    assert convert.words_to_numpy(short).tolist() == want[:5]


def test_api_takes_the_two_step_path(jax_runs):
    """api.encode_batch on a device (here the CPU) sends each same-shape
    batch through the two-step encode, input order kept: every blob equals
    hostref, nothing falls back, and the counters say which branch ran."""
    imgs = [im for name in ("deep", "three", "longrun") for im in jax_runs[name][0]]
    order = [4, 0, 5, 1, 2, 3]
    mixed = [imgs[i] for i in order]
    stats = {}
    out = nicetpu_torch.encode_batch(mixed, device="cpu", stats=stats)
    assert out == [oracle.encode_native(im) for im in mixed]
    assert stats == {"device": "cpu", "overflow_fallbacks": 0, "retokenized": 2, "slot_mode": 1}
    assert nicetpu_torch.encode(imgs[0], config=RuntimeConfig(backend="cpu")) == oracle.encode_native(imgs[0])


def test_encode_batch_checks(monkeypatch):
    with pytest.raises(ValueError):
        tenc.encode_batch(np.zeros((1, 4, 3, 3), np.uint8), device="cpu")  # width < 4
    with pytest.raises(ValueError):
        tenc.encode_batch(np.zeros((4, 8, 3), np.uint8), device="cpu")
    with pytest.raises(ValueError):
        tenc.encode_v2(np.zeros((4, 8, 3), np.int32), device="cpu")
    real = tenc.pack_compact

    def one_bit_more(*a, **kw):
        words, totals, ovf = real(*a, **kw)
        return words, totals + 1, ovf

    monkeypatch.setattr(tenc, "pack_compact", one_bit_more)
    with pytest.raises(RuntimeError, match="image 0 of the batch"):
        tenc.encode_batch(_three()[:1], device="cpu")
