"""The port's decode modules (nicetpu_torch.kernels.decode3 / decode_dev /
recon / cuda_ops.value_join) against the JAX package, stage by stage.

The same numpy-seeded inputs go through the JAX function (the walk through
`walk_ref`, the value join through `value_join_pallas` in interpret mode,
the reconstruction through `decode_dev.reconstruct_rows`) and the port's
plain version on the CPU.  Everything here is integer arithmetic, so every
comparison is exact (tolerance 0).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.format import constants as C
from nicetpu.format import huffman
from nicetpu.hostref import oracle
from nicetpu.kernels import decode3 as jd3
from nicetpu.kernels import decode_dev as jdd
from nicetpu.kernels.pallas_ops import value_join_pallas
from nicetpu_torch.kernels import cuda_ops, recon
from nicetpu_torch.kernels import decode3 as td3
from nicetpu_torch.kernels import decode_dev as tdd
from nicetpu_torch.kernels.geometry import Geometry

from test_torch_huffman_dev import _deep


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want))


def _lengths(seed, B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        fl, _, _ = huffman.build_all_tables(rng.integers(0, 50, 858).astype(np.int64))
        out.append(fl)
    return np.stack(out).astype(np.int32)


def _image(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 40 * np.sin(xx / 7.0) + 30 * np.cos(yy / 5.0)
    img = base[..., None] + np.array([0, 7, -9]) + rng.integers(-3, 4, (h, w, 3))
    img[h // 4 : h // 4 + 4] = img[h // 4, 0]  # a flat band: runs with digits
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def test_tables_match_jax():
    lens = _lengths(7, 3)
    want = jd3.prepare_tables_v3_jnp(jnp.asarray(lens))
    got = td3.prepare_tables_v3(_t(lens))
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[-1].all()


def test_tables_reject_bad_lengths_and_kraft_multiples():
    lens = _lengths(11, 4)
    lens[1, 5] += 1  # breaks stream 0's Kraft sum
    lens[2, 0] = 0  # a length out of range
    lens[3, :256] = 7  # 256 codes of 7 bits: a Kraft sum of exactly 2 * 2**32
    *_, jok = jd3.prepare_tables_v3_jnp(jnp.asarray(lens))
    *_, tok = td3.prepare_tables_v3(_t(lens))
    assert tok.tolist() == [True, False, False, False]
    # the JAX int32 sum wraps to 0 on the multiple of 2**32 and accepts it;
    # the port holds stream 3 to validate_flat_lengths, which rejects it
    assert np.asarray(jok).tolist() == [True, False, False, True]
    with pytest.raises(ValueError):
        huffman.validate_flat_lengths(lens[3])


def test_derive_walk_tables_matches_jax():
    af, pr, ib, *_ = jd3.prepare_tables_v3_jnp(jnp.asarray(_lengths(3, 2)))
    rng = np.random.default_rng(5)  # arbitrary words: the wrapping arithmetic
    raf = rng.integers(-(2**31), 2**31, (2, 10, 32)).astype(np.int32)
    rpr = (rng.random((2, 10, 32)) < 0.4).astype(np.int32)
    rpr[1, 4] = 0  # a stream with no length present
    rib = rng.integers(-(2**31), 2**31, (2, 10, 32)).astype(np.int32)
    for a, p, i in ((af, pr, ib), (raf, rpr, rib)):
        want = jd3.derive_walk_tables(jnp.asarray(a), jnp.asarray(p), jnp.asarray(i))
        got = td3.derive_walk_tables(_t(a), _t(p), _t(i))
        for g, w in zip(got, want):
            _eq(g, w)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


def _walk_args(lengths, words_u32, wbits):
    """JAX tables + words for one image -> (jax args, torch args)."""
    af, pr, ib, pfx, *_ = jd3.prepare_tables_v3_jnp(jnp.asarray(lengths[None].astype(np.int32)))
    aff, dD, inc = jd3.derive_walk_tables(af, pr, ib)
    words = words_u32.view(np.int32)
    jargs = (jnp.asarray(words), aff[0], dD[0], inc[0], pfx[0, 0], jnp.int32(wbits))
    targs = (_t(words[None]), _t(aff), _t(dD), _t(inc), _t(pfx), _t(np.array([wbits], np.int32)))
    return jargs, targs


def _payload_words(data, extra_words):
    """A `.nice` stream -> (code lengths, payload words + zero tail, wbits)."""
    from nicetpu.format import headers

    lengths = headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :]).astype(np.int64)
    payload = data[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(data) - 4]
    src = np.frombuffer(payload + b"\0" * ((-len(payload)) % 4), dtype=">u4").astype(np.uint32)
    return lengths, np.concatenate([src, np.zeros(extra_words, np.uint32)]), len(payload) * 8


def _compare_walk(jargs, targs, *, chunk_bits, steps, nch, maxl, rounds=2, jwalk=None):
    jwords, aff, dD, inc, pfx, wb = jargs
    if jwalk is None:
        jwalk = jax.jit(partial(jd3.walk_ref, chunk_bits=chunk_bits, steps=steps, maxl=maxl))
    e = np.arange(nch, dtype=np.int32) * chunk_bits
    for _ in range(rounds):
        want = jwalk(jwords, jnp.asarray(e), aff, dD, inc, pfx, wb)
        got = td3.walk_plain(targs[0], _t(e[None]), *targs[1:], chunk_bits=chunk_bits, steps=steps)
        for g, w in zip(got, want):
            _eq(g[0], w)
        ex = np.asarray(want[4])
        e = np.concatenate([[0], ex[:-1]]).astype(np.int32)


@pytest.mark.parametrize("chunk_bits", [512, 2048])
def test_walk_matches_walk_ref_on_an_encoded_image(chunk_bits):
    lengths, words, wbits = _payload_words(oracle.encode_native(_image()), 80)
    nch = -(-wbits // chunk_bits) + 1  # one chunk past the payload stays dead
    jargs, targs = _walk_args(lengths, words, wbits)
    _compare_walk(jargs, targs, chunk_bits=chunk_bits, steps=jd3._steps(chunk_bits, 8), nch=nch,
                  maxl=jd3.FUSED_MAXL)


def _deep_stream(seed=0, groups=300):
    """A payload of random pixel groups under tables with codes up to 31
    bits (the deep-code fixture's LUMA_OTHER_DIFF stream), its symbols drawn
    uniformly so that the deep codes are common."""
    lengths, codes, _ = huffman.build_all_tables(_deep()[0])
    lengths = lengths.astype(np.int64)
    assert lengths[C.STREAM_BASE[C.SC_LUMA_OTHER_DIFF] :][:32].max() > jd3.MAXL_BASE
    rng = np.random.default_rng(seed)
    bits = []

    def put(s, sym):
        ln = int(lengths[C.STREAM_BASE[s] + sym])
        code = int(codes[C.STREAM_BASE[s] + sym])
        bits.extend((code >> (ln - 1 - i)) & 1 for i in range(ln))

    for _ in range(groups):
        mode = int(rng.choice([2, 2, 2, 0, 1, 3, 4, 7]))  # mostly COLOR_LUMA
        put(C.SC_PREFIXES, mode)
        if mode < 5:
            for s in jdd.SLOT_STREAM[mode]:
                if s >= 0:
                    put(s, int(rng.integers(0, C.ALPHABET_SIZES[s])))
    wbits = len(bits)
    bits += [0] * (-len(bits) % 32 + 32 * 80)
    words = np.packbits(np.array(bits, np.uint8)).view(">u4").astype(np.uint32)
    return lengths, words, wbits


def test_walk_deep_codes_match_every_gating_of_the_jax_walk(monkeypatch):
    """The JAX walk skips work with GATING and the static `maxl` bounds; the
    port sums every length up to `_deep_cap`.  The results are the same."""
    lengths, words, wbits = _deep_stream()
    chunk_bits = 512
    nch = -(-wbits // chunk_bits)
    steps = jd3._steps(chunk_bits, 8)
    jargs, targs = _walk_args(lengths, words, wbits)
    for maxl in (jd3.FUSED_MAXL, (8,) * C.NUM_STREAMS):
        _compare_walk(jargs, targs, chunk_bits=chunk_bits, steps=steps, nch=nch, maxl=maxl, rounds=1)
    monkeypatch.setattr(jd3, "GATING", False)
    _compare_walk(jargs, targs, chunk_bits=chunk_bits, steps=steps, nch=nch, maxl=(8,) * 10,
                  rounds=1, jwalk=partial(jd3.walk_ref, chunk_bits=chunk_bits, steps=steps,
                                          maxl=(8,) * 10))


def test_walk_wrapper_checks_inputs():
    lengths, words, wbits = _payload_words(oracle.encode_native(_image(8, 8)), 80)
    _, (w, aff, dD, inc, pfx, wb) = _walk_args(lengths, words, wbits)
    e = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        td3.walk(w, e, aff, dD, inc, pfx[:, :, :8].contiguous(), wb, chunk_bits=512, steps=64)
    with pytest.raises(TypeError):
        td3.walk(w.to(torch.int64), e, aff, dD, inc, pfx, wb, chunk_bits=512, steps=64)
    exits = td3.walk(w, e, aff, dD, inc, pfx, wb, chunk_bits=512, steps=64, records=False)
    assert exits[:4] == (None,) * 4 and exits[4].shape == (1, 1)


# ---------------------------------------------------------------------------
# value join
# ---------------------------------------------------------------------------


def test_value_join_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    B, M = 2, 3000
    bins = rng.integers(0, 1100, (B, M)).astype(np.int32)  # about 20 % holes
    tbl = rng.integers(0, 2**16, (B, C.TOTAL_SYMBOLS)).astype(np.int32)
    want = value_join_pallas(jnp.asarray(bins), jnp.asarray(tbl), interpret=True)
    _eq(cuda_ops.value_join(_t(bins[None]), _t(tbl))[0], want)


def test_value_join_negative_bins_follow_sym_join():
    """A negative bin (possible only under corrupt tables) reads entry 0, as
    the gather in JAX's `_sym_join` does."""
    rng = np.random.default_rng(10)
    bins = rng.integers(-5, 1100, (3, 2, 500)).astype(np.int32)
    tbl = rng.integers(0, 2**16, (2, C.TOTAL_SYMBOLS)).astype(np.int32)
    got = cuda_ops.value_join(_t(bins), _t(tbl))
    for k in range(3):
        _eq(got[k], jd3._sym_join(jnp.asarray(bins[k]), jnp.asarray(tbl)))


# ---------------------------------------------------------------------------
# assembly and placement
# ---------------------------------------------------------------------------


def _placed_records(img, chunk_bits=512):
    """The port's decode of a hostref stream up to the walk records:
    (pos, sym, i12, i34 as (1, S), wbits, sym_tbl), after two rounds."""
    args, _ = jd3.prepare_batch_args([oracle.encode_native(img)], chunk_bits=chunk_bits,
                                     steps_div=8, rounds=2)
    words, wbits, af, pr, ib, pfx, sym_tbl = (torch.from_numpy(np.array(a)) for a in args)
    aff, dD, inc = td3.derive_walk_tables(af, pr, ib)
    nch = -(-int(wbits[0]) // chunk_bits) + 1
    steps = td3._steps(chunk_bits, 8)
    e = (torch.arange(nch, dtype=torch.int32) * chunk_bits)[None]
    ex = td3.walk_plain(words, e, aff, dD, inc, pfx, wbits, chunk_bits=chunk_bits, steps=steps)[4]
    e = torch.cat([torch.zeros_like(ex[:, :1]), ex[:, :-1]], dim=1)
    recs = td3.walk_plain(words, e, aff, dD, inc, pfx, wbits, chunk_bits=chunk_bits, steps=steps)
    return [r.reshape(1, -1) for r in recs[:4]], wbits, sym_tbl


def test_assemble_and_place_match_jax():
    img = _image(24, 32, seed=2)
    H, W = img.shape[:2]
    N = H * W
    (pos, sym, i12, i34), wbits, sym_tbl = _placed_records(img)
    bins = td3._payload_bins(sym, i12, i34)
    jbins = jd3._payload_bins(*(jnp.asarray(x.numpy()) for x in (sym, i12, i34)))
    for g, w in zip(bins, jbins):
        _eq(g, w)
    p = cuda_ops.value_join(bins, sym_tbl)
    jp = [jnp.asarray(x.numpy()) for x in p]
    geom = Geometry.uniform(W, N, 1, "cpu")
    rec, dst, (ok_cov, ok_ref) = td3.assemble_v3(pos, sym, *p, wbits, geom=geom)
    jrec, jdst, (jcov, jref) = jd3.assemble_v3(jnp.asarray(pos.numpy()), jnp.asarray(sym.numpy()),
                                               *jp, N, W, jnp.asarray(wbits.numpy()))
    for g, w in ((rec, jrec), (dst, jdst), (ok_cov, jcov), (ok_ref, jref)):
        _eq(g, w)
    assert ok_cov.all() and ok_ref.all()
    got = td3.place_and_unpack(rec, dst, geom=geom)
    want = jd3.place_and_unpack(jrec, jdst, N, W)
    for g, w in zip(got, want):
        _eq(g, w)
    out = recon.reconstruct_rows(*got, width=W)
    np.testing.assert_array_equal(out[0].numpy().reshape(3, H, W).transpose(1, 2, 0), img)


# ---------------------------------------------------------------------------
# the row reconstruction
# ---------------------------------------------------------------------------


def _recon_inputs(B, H, W, seed):
    rng = np.random.default_rng(seed)
    N = H * W
    form = rng.integers(0, 5, (B, N)).astype(np.int32)
    delta = rng.integers(0, 256, (B, 3, N)).astype(np.int32)
    choices = np.array([0] + tdd._const_offsets(W), np.int32)
    refoff = np.where(form == 0, rng.choice(choices, (B, N)), 0).astype(np.int32)
    return form, delta, refoff


# 2 x 12 x 256, and the golden rasters' widths (6, 7, 12, 14) and MIN_WIDTH
@pytest.mark.parametrize("B,H,W", [(2, 12, 256), (2, 8, 6), (2, 9, 7), (2, 16, 12), (2, 20, 14),
                                   (2, 6, 4)])
def test_reconstruct_rows_matches_jax(B, H, W):
    form, delta, refoff = _recon_inputs(B, H, W, seed=W)
    N = H * W
    jrecon = jax.jit(jax.vmap(partial(jdd.reconstruct_rows, n_pixels=N, width=W,
                                      segs=jdd._pick_segs(W))))
    want = jrecon(jnp.asarray(form), jnp.asarray(delta), jnp.asarray(refoff))
    _eq(recon.reconstruct_rows(_t(form), _t(delta), _t(refoff), width=W), want)


def test_reconstruct_serial_agrees_on_a_valid_stream():
    """`reconstruct_serial` clamps reads before the raster start where
    `reconstruct_rows` reads zeros: the two agree on a real stream, and
    random forms tell them apart."""
    img = _image(6, 10, seed=4)
    (pos, sym, i12, i34), wbits, sym_tbl = _placed_records(img)
    p = cuda_ops.value_join(td3._payload_bins(sym, i12, i34), sym_tbl)
    geom = Geometry.uniform(10, 60, 1, "cpu")
    rec, dst, _ = td3.assemble_v3(pos, sym, *p, wbits, geom=geom)
    form, delta, refoff = td3.place_and_unpack(rec, dst, geom=geom)
    rows = tdd.reconstruct_rows(form, delta, refoff, 60, 10)
    serial = tdd.reconstruct_serial(form[0], delta[0], refoff[0], 60, 10)
    assert torch.equal(rows[0], serial)
    np.testing.assert_array_equal(serial.numpy().reshape(3, 6, 10).transpose(1, 2, 0), img)
    form, delta, refoff = (_t(a) for a in _recon_inputs(1, 6, 10, seed=1))
    rows = tdd.reconstruct_rows(form, delta, refoff, 60, 10)
    assert not torch.equal(rows[0], tdd.reconstruct_serial(form[0], delta[0], refoff[0], 60, 10))
