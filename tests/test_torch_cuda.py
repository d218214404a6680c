"""The CUDA kernels and the device paths of nicetpu_torch, on a GPU.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX and nothing of the JAX package, so it also runs where JAX is
absent; skip the JAX conftest there:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import nicetpu_torch
from nicetpu_torch import cli, corpus, pipeline
from nicetpu_torch.config import RuntimeConfig
from nicetpu_torch.dist import launch, sharded_decode
from nicetpu_torch.format import constants as C
from nicetpu_torch.hostref import oracle
from nicetpu_torch.bench import make_image
from nicetpu_torch.kernels import cuda_ops, decode3, decode_dev, encode2, huffman_dev, recon
from nicetpu_torch.kernels import tokenize as tok
from nicetpu_torch.kernels.geometry import Geometry

from _decode_table_rows import INT64_ONLY, LENGTH_ROWS, WALK_ROWS
from _recon_rows import random_inputs as recon_random_inputs, seam_inputs as recon_seam_inputs
from _huffman_rows import _bounds, _deep, _heavy, _random, _sparse, _ties, _zero
from _slot_rows import CASES as SLOT_CASES, records as slot_records
from _stitch_rows import CASES as STITCH_CASES, HEADER_LENGTHS, header as stitch_header, random_bits
from _stitch_rows import shards as stitch_shards

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _bins(B, M, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, C.TOTAL_SYMBOLS, (B, M)).astype(np.int32)
    bins[rng.random((B, M)) < 0.3] = 1023
    bins[rng.random((B, M)) < 0.01] = -5  # any value outside [0, 858) is a hole
    return torch.from_numpy(bins)


def _tables(B, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 32, (B, C.TOTAL_SYMBOLS)).astype(np.int32)
    codes = rng.integers(0, 2**32, (B, C.TOTAL_SYMBOLS), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(lengths), torch.from_numpy(codes.view(np.int32))


def _slots(B, Mg, S, seed):
    rng = np.random.default_rng(seed)
    aob = rng.integers(0, 32, (B, Mg, S)).astype(np.int32)
    aob[rng.random((B, Mg, S)) < 0.4] = 0
    code = rng.integers(0, 2**32, (B, Mg, S), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(aob), torch.from_numpy(code.view(np.int32))


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# (1, 1_100_001): slices rounded up to multiples of 4 leave the last blocks
# of the grid with no tokens at all
@pytest.mark.parametrize("B,M", [(3, 100_003), (2, 4096), (1, 1), (5, 7), (1, 1_100_001)])
def test_histogram_and_join_match_plain(dev, B, M):
    bins = _bins(B, M, seed=M).to(dev)
    lengths, codes = (t.to(dev) for t in _tables(B, seed=1))
    before = dict(cuda_ops.LAUNCHES)
    _same(cuda_ops.histogram(bins), cuda_ops.histogram_plain(bins))
    _same(cuda_ops.table_join(bins, lengths, codes), cuda_ops.table_join_plain(bins, lengths, codes))
    assert cuda_ops.LAUNCHES["histogram"] == before["histogram"] + 1
    assert cuda_ops.LAUNCHES["table_join"] == before["table_join"] + 1


def test_join_on_an_unaligned_view(dev):
    """A one-row view starting one element in: the kernels take their
    scalar path instead of int4 loads."""
    bins = _bins(1, 5001, seed=3).to(dev)[:, 1:]
    assert bins.is_contiguous() and bins.data_ptr() % 16 != 0
    lengths, codes = (t.to(dev) for t in _tables(1, seed=4))
    _same(cuda_ops.histogram(bins), cuda_ops.histogram_plain(bins))
    _same(cuda_ops.table_join(bins, lengths, codes), cuda_ops.table_join_plain(bins, lengths, codes))


@pytest.mark.parametrize("S", [64, 128, 16, 13])
def test_fold_matches_plain(dev, S):
    aob, code = (t.to(dev) for t in _slots(2, 1000, S, seed=S))
    before = cuda_ops.LAUNCHES["fold_records"]
    _same(cuda_ops.fold_records(aob, code), cuda_ops.fold_records_plain(aob, code))
    assert cuda_ops.LAUNCHES["fold_records"] == before + 1


# group counts that fill no whole block of 128, one group, one slot, a last
# tile of 4 or 8 slots (S = 20, 200)
@pytest.mark.parametrize("B,Mg,S", [(1, 1, 64), (3, 129, 7), (1, 127, 1), (2, 257, 20), (1, 5, 200)])
def test_fold_on_ragged_shapes(dev, B, Mg, S):
    aob, code = (t.to(dev) for t in _slots(B, Mg, S, seed=Mg))
    _same(cuda_ops.fold_records(aob, code), cuda_ops.fold_records_plain(aob, code))


@pytest.mark.parametrize("S", [13, 64])
def test_fold_on_an_unaligned_view(dev, S):
    """A view starting one element in: no row is 16-byte aligned."""
    aob, code = (t.to(dev).flatten()[1 : 1 + 1000 * S].view(1, 1000, S)
                 for t in _slots(1, 1001, S, seed=S))
    assert aob.is_contiguous() and aob.data_ptr() % 16 != 0
    _same(cuda_ops.fold_records(aob, code), cuda_ops.fold_records_plain(aob, code))


def test_fold_lengths_of_32_and_records_over_320_bits(dev):
    rng = np.random.default_rng(32)
    aob = torch.from_numpy(rng.integers(0, 33, (2, 1000, 64)).astype(np.int32)).to(dev)
    code = _slots(2, 1000, 64, seed=33)[1].to(dev)
    rec, k = cuda_ops.fold_records(aob, code)
    assert bool((k > 32 * cuda_ops.FOLD_CAPW).all())
    _same((rec, k), cuda_ops.fold_records_plain(aob, code))


@pytest.mark.parametrize("bad", [33, 100, -1, 2**20, -(2**20)])
def test_fold_lengths_outside_the_window(dev, bad):
    """Groups holding a length outside 0..32 take the kernel's generic fold
    and still equal the plain version; their neighbours keep the window.
    (Lengths whose sums leave int32 wrap in the kernel as in the Pallas
    kernel, and not in the plain version's int64.)"""
    aob, code = (t.to(dev) for t in _slots(2, 1000, 64, seed=9))
    aob[:, ::3, 5] = bad
    _same(cuda_ops.fold_records(aob, code), cuda_ops.fold_records_plain(aob, code))


def test_wrappers_reject_mixed_devices(dev):
    bins = _bins(1, 64, seed=5).to(dev)
    lengths, codes = _tables(1, seed=6)  # left on the CPU
    with pytest.raises(ValueError):
        cuda_ops.table_join(bins, lengths, codes)


def _encode_batch_images():
    rng = np.random.default_rng(7)
    smooth = np.clip(
        128 + 40 * np.sin(np.arange(48)[None, :, None] / 5.0)
        + rng.integers(-3, 4, (40, 48, 3)), 0, 255,
    ).astype(np.uint8)
    long_run = np.zeros((40, 48, 3), np.uint8)  # a 1919-pixel run: more than 3 run digits
    long_run[0, 0] = 7
    noise = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    return [smooth, long_run, noise, smooth[::-1].copy()]


def test_encode_batch_cuda_matches_native(dev):
    """api.encode_batch takes the two-step encode: the long-run image keeps
    its batch on the device, tokenized again with 11 run digits."""
    imgs = _encode_batch_images()
    cuda_ops.reset_launches()
    stats = {}
    out = nicetpu_torch.encode_batch(imgs, device="cuda", stats=stats)
    assert out == [oracle.encode_native(im) for im in imgs]
    # the (40, 48) batch holds 3 images, all tokenized again
    assert stats == {"device": "cuda", "overflow_fallbacks": 0, "retokenized": 3, "slot_mode": 0}
    # two histograms for the re-tokenized batch, one for the other shape
    encode_kernels = ("histogram", "table_join", "fold_records")
    assert [cuda_ops.LAUNCHES[k] for k in encode_kernels] == [3, 2, 2]


def test_encode_batch_fused_cuda_sends_the_long_run_to_the_host(dev):
    """The fused path of the schedulers keeps its host route: the long-run
    image overflows and the native encoder serves it, counted."""
    imgs = _encode_batch_images()
    same = [imgs[0], imgs[1], imgs[3]]
    cuda_ops.reset_launches()
    stats = {}
    out = pipeline.encode_batch_fused(same, device=torch.device("cuda"), stats=stats)
    assert out == [oracle.encode_native(im) for im in same]
    assert stats == {"overflow_fallbacks": 1}
    fused_kernels = ("histogram", "huffman_tables", "table_join", "fold_records")
    assert all(cuda_ops.LAUNCHES[k] == 1 for k in fused_kernels)


# ---------------------------------------------------------------------------
# Huffman tables: the kernel against the plain version on the CPU
# ---------------------------------------------------------------------------


def _image_counts(B, side=64):
    imgs = np.stack([make_image(side, side, seed) for seed in range(B)])
    _, stats = encode2.tokenize_compact(torch.from_numpy(imgs.reshape(B, -1, 3)), width=side, ndigits_cap=3)
    return stats[:, :-1].numpy().astype(np.int64)


HUFFMAN_ROWS = {"random": lambda: _random(7), "sparse": lambda: _sparse(8), "deep": _deep, "zero": _zero,
                "heavy": lambda: _heavy(9), "ties": lambda: _ties(11), "bounds": lambda: _bounds(14),
                "make_image": lambda: _image_counts(3),
                "B=1": lambda: _random(10)[:1], "B=32": lambda: _image_counts(32, side=32)}


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", sorted(HUFFMAN_ROWS))
def test_huffman_tables_match_plain(dev, case, dtype):
    """One launch, equal to the plain version bit for bit; the deep rows'
    row 1 takes the clamped merge, the tie rows take equal-weight internal
    nodes out of creation order."""
    counts = torch.from_numpy(HUFFMAN_ROWS[case]()).to(dtype)
    want = huffman_dev.build_tables_device_plain(counts)
    cuda_ops.reset_launches()
    got = huffman_dev.build_tables_device(counts.to(dev))
    assert cuda_ops.LAUNCHES["huffman_tables"] == 1
    _same(tuple(g.cpu() for g in got), want)


def test_huffman_tables_read_nothing_back(dev):
    counts = torch.from_numpy(_deep()).to(dev)
    want = huffman_dev.build_tables_device(counts)  # builds the library outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = huffman_dev.build_tables_device(counts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(got, want)


# ---------------------------------------------------------------------------
# the tokenizer kernel against its plain version on the CPU
# ---------------------------------------------------------------------------


def _flat(imgs):
    return torch.from_numpy(np.stack([im.reshape(-1, 3) for im in imgs]))


def _tokenize_case(case):
    """(x_ext on the CPU, tokenize_bins keywords but the cap)."""
    if case == "sharded":  # rank 1 of 4 row blocks of 64 x 40, its last run ended by a later shard
        img = make_image(64, 40, 3)
        img[29:37] = img[29, 0]
        x, halo, n_local = img.reshape(-1, 3), tok.halo_pixels(40), 16 * 40
        x_ext = torch.from_numpy(np.ascontiguousarray(x[n_local - halo : 2 * n_local]))[None]
        return x_ext, dict(width=40, halo=halo, g0=n_local, n_total=64 * 40, invalid_bin=C.TOTAL_SYMBOLS,
                           tail=torch.tensor([37 * 40, 48 * 40], dtype=torch.int32))
    if case == "constant":  # one run over every tile
        x = torch.full((2, 96 * 64, 3), 5, dtype=torch.uint8)
    elif case == "last_pixel":
        x = torch.zeros(1, 96 * 64, 3, dtype=torch.uint8)
        x[0, -1] = 1
    else:
        h, w = {"W4": (700, 4), "W5": (301, 5), "W64": (64, 64), "W1100": (5, 1100), "W29051": (3, 29051)}[case]
        x = _flat([make_image(h, w, s) for s in range(3)])
        w = int(case[1:])
        return x, dict(width=w, halo=0, g0=0, n_total=x.shape[1], invalid_bin=encode2.INVALID_BIN)
    return x, dict(width=64, halo=0, g0=0, n_total=x.shape[1], invalid_bin=encode2.INVALID_BIN)


@pytest.mark.parametrize("cap", [3, 5, C.MAX_RUN_DIGITS])
@pytest.mark.parametrize("case", ["W4", "W5", "W64", "W1100", "W29051", "constant", "last_pixel", "sharded"])
def test_tokenize_matches_plain(dev, case, cap):
    """One counted launch, equal to the plain version bit for bit, the
    overflow flags included; cap 5's 10 slots take the scalar stores."""
    x, kw = _tokenize_case(case)
    want = tok.tokenize_bins_plain(x, ndigits_cap=cap, **kw)
    kw_d = dict(kw, tail=kw["tail"].to(dev)) if "tail" in kw else kw
    before = cuda_ops.LAUNCHES["tokenize"]
    got = tok.tokenize_bins(x.to(dev), ndigits_cap=cap, **kw_d)
    assert cuda_ops.LAUNCHES["tokenize"] == before + 1
    _same(tuple(g.cpu() for g in got), want)
    if case in ("constant", "last_pixel"):
        assert bool(want[1].all()) == (cap < 4)


def test_tokenize_with_first_change_and_no_host_sync(dev):
    """The sharded path's call: first_change, then the kernel with a tail,
    all under set_sync_debug_mode("error")."""
    x, kw = _tokenize_case("sharded")
    want = tok.tokenize_bins_plain(x, ndigits_cap=C.MAX_RUN_DIGITS, **kw)
    img = make_image(64, 40, 3)  # the raster of _tokenize_case("sharded"): ranks 2 and 3 give the tail
    img[29:37] = img[29, 0]
    flat, halo, n_local = torch.from_numpy(img.reshape(1, -1, 3)), tok.halo_pixels(40), 16 * 40
    later = [(flat[:, r * n_local - halo : (r + 1) * n_local].contiguous(), dict(halo=halo, g0=r * n_local,
                                                                               n_total=64 * 40)) for r in (2, 3)]
    firsts = [tok.first_change_plain(xr, **at) for xr, at in later]
    assert torch.equal(torch.cat(firsts), kw["tail"])
    for (xr, at), f in zip(later, firsts):
        assert torch.equal(tok.first_change(xr.to(dev), **at).cpu(), f)
    x_d, later_d = x.to(dev), [(xr.to(dev), at) for xr, at in later]
    tok.tokenize_bins(x_d, ndigits_cap=C.MAX_RUN_DIGITS, **dict(kw, tail=kw["tail"].to(dev)))  # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tail = torch.cat([tok.first_change(xr, **at) for xr, at in later_d])
        got = tok.tokenize_bins(x_d, ndigits_cap=C.MAX_RUN_DIGITS, **dict(kw, tail=tail))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(tuple(g.cpu() for g in got), want)


@pytest.mark.parametrize("case", ["constant", "last_pixel", "W4"])
def test_first_change_matches_plain(dev, case):
    """Each image's first change, at g0 = 0 and past a halo."""
    x, _ = _tokenize_case(case)
    for halo, g0 in ((0, 0), (64, 5000)):
        at = dict(halo=halo, g0=g0, n_total=g0 + x.shape[1] - halo)
        np.testing.assert_array_equal(tok.first_change(x.to(dev), **at).cpu().numpy(),
                                      tok.first_change_plain(x, **at).numpy())


def test_tokenize_on_an_unaligned_view(dev):
    """A contiguous view whose data starts 3 bytes past a word: the kernel
    stages it pixel by pixel, with the same result."""
    x, kw = _tokenize_case("W1100")
    view = x.to(dev)[1:2, 1:]
    assert view.is_contiguous() and view.data_ptr() % 4
    kw = dict(kw, n_total=view.shape[1])
    _same(tuple(g.cpu() for g in tok.tokenize_bins(view, ndigits_cap=3, **kw)),
          tok.tokenize_bins_plain(view.cpu(), ndigits_cap=3, **kw))


def test_tokenize_calls_agree_and_reset(dev):
    """20 back-to-back calls give equal outputs (the scratch's tickets and
    words are reset each call), at 64 images: more blocks than fit on the
    card at once."""
    x = _flat([make_image(64, 64, s % 5) for s in range(64)])
    kw = dict(width=64, halo=0, g0=0, n_total=x.shape[1], ndigits_cap=3, invalid_bin=encode2.INVALID_BIN)
    want = tok.tokenize_bins_plain(x, **kw)
    x_d = x.to(dev)
    calls = [tok.tokenize_bins(x_d, **kw) for _ in range(20)]
    for got in calls:
        _same(tuple(g.cpu() for g in got), want)


def test_tokenize_refuses_what_the_kernel_does_not_take(dev):
    """A CUDA tensor the kernel refuses raises; it never reaches the plain version."""
    x = torch.zeros(65536, 8, 3, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        tok.tokenize_bins(x, width=4, halo=0, g0=0, n_total=8, ndigits_cap=3, invalid_bin=1023)


# ---------------------------------------------------------------------------
# decode tables: the two kernels against their plain versions on the CPU
# (all ten tables in one launch of decode_tables; walk_tables alone on any
# tables)
# ---------------------------------------------------------------------------

TABLE_CASES = [(name, dtype) for name in LENGTH_ROWS for dtype in (torch.int32, torch.int64)
               if dtype == torch.int64 or name not in INT64_ONLY]


@pytest.mark.parametrize("name,dtype", TABLE_CASES, ids=[f"{n}-{str(d)[6:]}" for n, d in TABLE_CASES])
def test_decode_and_walk_tables_match_plain(dev, name, dtype):
    """All ten tables in one launch, equal to the plain pair bit for bit,
    tables_ok on the bad rows included; the seven alone in one launch; the
    walk_tables kernel on the kernel's tables equal to the fused walk's."""
    lens = torch.from_numpy(LENGTH_ROWS[name]()).to(dtype)
    want = decode3.prepare_tables_v3_plain(lens)
    want_w = decode3.derive_walk_tables_plain(*want[:3])
    cuda_ops.reset_launches()
    got = decode3.prepare_tables_v3(lens.to(dev), walk=True)
    assert (cuda_ops.LAUNCHES["decode_tables"], cuda_ops.LAUNCHES["walk_tables"]) == (1, 0)
    assert len(got) == 10 and all(g.is_contiguous() for g in got)
    _same(tuple(g.cpu() for g in got), want + want_w)
    alone = decode3.prepare_tables_v3(lens.to(dev))
    assert cuda_ops.LAUNCHES["decode_tables"] == 2
    _same(tuple(g.cpu() for g in alone), want)
    got_w = decode3.derive_walk_tables(*got[:3])
    assert cuda_ops.LAUNCHES["walk_tables"] == 1
    _same(got_w, got[7:])


@pytest.mark.parametrize("name", sorted(WALK_ROWS))
def test_walk_tables_on_arbitrary_words_match_plain(dev, name):
    words = tuple(torch.from_numpy(x) for x in WALK_ROWS[name]())
    cuda_ops.reset_launches()
    got = decode3.derive_walk_tables(*(w.to(dev) for w in words))
    assert cuda_ops.LAUNCHES["walk_tables"] == 1
    _same(tuple(g.cpu() for g in got), decode3.derive_walk_tables_plain(*words))


def test_decode_tables_read_nothing_back(dev):
    """encode_fused_core -> prepare_tables_v3(walk=True) under
    set_sync_debug_mode("error"): one launch, no host sync."""
    flat = _flat([make_image(64, 64, s) for s in range(3)]).to(dev)
    kw = dict(geom=Geometry.uniform(64, 64 * 64, 3, dev), ndigits_cap=3, w_cap=pipeline.w_cap(64 * 64))

    def run():
        lengths = encode2.encode_fused_core(flat, **kw)[1]
        return lengths, decode3.prepare_tables_v3(lengths, walk=True)

    run()  # builds the library outside the check
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lengths, tables = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (cuda_ops.LAUNCHES["decode_tables"], cuda_ops.LAUNCHES["walk_tables"]) == (1, 0)
    want = decode3.prepare_tables_v3_plain(lengths.cpu())
    _same(tuple(t.cpu() for t in tables), want + decode3.derive_walk_tables_plain(*want[:3]))
    assert bool(tables[6].all())


def test_table_wrappers_refuse_bad_inputs_on_the_card(dev):
    lens = torch.from_numpy(LENGTH_ROWS["valid"]()).to(dev)
    for bad in (lens.float(), lens.to(torch.int16), lens[:, :857], lens[:0], lens[0]):
        for walk in (False, True):
            with pytest.raises((TypeError, ValueError)):
                cuda_ops.decode_tables(bad, walk=walk)
    af, pr, ib = decode3.prepare_tables_v3(lens)[:3]
    for bad in ((af.to(torch.int64), pr, ib), (af, pr.cpu(), ib), (af[..., :31].contiguous(), pr, ib),
                (af, pr[:1].contiguous(), ib), (af.repeat_interleave(2, -1)[..., ::2], pr, ib)):
        with pytest.raises((TypeError, ValueError)):
            cuda_ops.walk_tables(*bad)


def test_a_cuda_tensor_never_reaches_the_plain_tables(dev, monkeypatch):
    def boom(*a):
        raise AssertionError("plain version reached")

    lens = torch.from_numpy(LENGTH_ROWS["valid"]()).to(dev)
    want = decode3.prepare_tables_v3(lens, walk=True)
    want_w = decode3.derive_walk_tables(*want[:3])
    monkeypatch.setattr(decode3, "prepare_tables_v3_plain", boom)
    monkeypatch.setattr(decode3, "derive_walk_tables_plain", boom)
    _same(decode3.prepare_tables_v3(lens, walk=True), want)
    _same(decode3.prepare_tables_v3(lens), want[:7])
    _same(decode3.derive_walk_tables(*want[:3]), want_w)


# ---------------------------------------------------------------------------
# decode kernels: walk, value join, row reconstruction
# ---------------------------------------------------------------------------


def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 40 * np.sin(xx / 7.0 + seed) + 30 * np.cos(yy / 5.0)
    img = base[..., None] + np.array([0, 7, -9]) + rng.integers(-3, 4, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _walk_inputs(imgs, dev):
    datas = [oracle.encode_native(im) for im in imgs]
    (words, wbits, af, pr, ib, pfx, _), _ = decode3.prepare_batch_args(datas, device=dev)
    aff, dD, inc = decode3.derive_walk_tables(af, pr, ib)
    return words, wbits, aff, dD, inc, pfx


# (1, 6, 8): one chunk; (2, 40, 64) and (1, 64, 80): chunk counts that are not
# a multiple of the kernel's 64-thread block
@pytest.mark.parametrize("B,h,w", [(1, 6, 8), (2, 40, 64), (1, 64, 80)])
@pytest.mark.parametrize("chunk_bits,steps_div", [(512, 8), (2048, 8), (4096, 3)])
def test_walk_matches_plain(dev, B, h, w, chunk_bits, steps_div):
    words, wbits, aff, dD, inc, pfx = _walk_inputs([_smooth(h, w, s) for s in range(B)], dev)
    nch = -(-int(wbits.max()) // chunk_bits)
    words = words[:, : nch * chunk_bits // 32 + 72].contiguous()
    steps = decode3._steps(chunk_bits, steps_div)
    starts = (torch.arange(nch, dtype=torch.int32, device=dev) * chunk_bits).expand(B, nch)
    e = starts.contiguous()
    kw = dict(chunk_bits=chunk_bits, steps=steps)
    for records in (False, True):  # round 1 (exits only), then round 2 from its exits
        before = cuda_ops.LAUNCHES["walk"]
        got = decode3.walk(words, e, aff, dD, inc, pfx, wbits, records=records, **kw)
        want = decode3.walk_plain(words, e, aff, dD, inc, pfx, wbits, records=records, **kw)
        assert cuda_ops.LAUNCHES["walk"] == before + 1
        for g, x in zip(got, want):
            assert (g is None and x is None) or torch.equal(g, x)
        e = torch.cat([torch.zeros_like(got[4][:, :1]), got[4][:, :-1]], dim=1)


def _deep_stream(groups=6000, seed=0):
    """Random pixel groups under tables with codes up to 31 bits: Fibonacci
    counts on the 32-symbol LUMA_OTHER_DIFF stream (the deep-code fixture of
    test_torch_huffman_dev, built here with the port's own tables, so that
    this file needs no JAX), symbols drawn uniformly so that deep codes are
    common.  Returns (words (1, Wn) int32 with an 80-word zero tail, wbits,
    aff, dD, inc, pfx) on the CPU."""
    from nicetpu_torch.kernels import huffman_dev

    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 1000, (1, C.TOTAL_SYMBOLS)).astype(np.int32)
    fib = [1, 1]
    while len(fib) < 32:
        fib.append(fib[-1] + fib[-2])
    base = C.STREAM_BASE[C.SC_LUMA_OTHER_DIFF]
    counts[0, base : base + 32] = fib
    lengths, codes, _ = huffman_dev.build_tables_device(torch.from_numpy(counts))
    lengths, codes = lengths[0].numpy().astype(np.int64), codes[0].numpy().view(np.uint32)
    assert lengths[base : base + 32].max() == C.MAX_CODE_LEN
    bits = []

    def put(s, sym):
        ln, code = int(lengths[C.STREAM_BASE[s] + sym]), int(codes[C.STREAM_BASE[s] + sym])
        bits.extend((code >> (ln - 1 - i)) & 1 for i in range(ln))

    for _ in range(groups):
        mode = int(rng.choice([2, 2, 2, 0, 1, 3, 4, 7]))  # mostly COLOR_LUMA
        put(C.SC_PREFIXES, mode)
        if mode < 5:
            for s in decode_dev.SLOT_STREAM[mode]:
                if s >= 0:
                    put(s, int(rng.integers(0, C.ALPHABET_SIZES[s])))
    wbits = len(bits)
    bits += [0] * (-len(bits) % 32 + 32 * 80)
    words = np.packbits(np.array(bits, np.uint8)).view(">u4").astype(np.uint32).view(np.int32)
    af, pr, ib, pfx, *_ = decode3.prepare_tables_v3(torch.from_numpy(lengths[None]))
    aff, dD, inc = decode3.derive_walk_tables(af, pr, ib)
    return torch.from_numpy(words[None].copy()), torch.tensor([wbits], dtype=torch.int32), aff, dD, inc, pfx


# "budget": a step budget too small to cross a chunk, so that the final round's
# entries lie before their chunks' starts (windows outside the staged words);
# "random": entries anywhere in the payload, before and past each block's range
@pytest.mark.parametrize("entries", ["budget", "random"])
@pytest.mark.parametrize("chunk_bits", [512, 2048])
def test_walk_deep_codes_off_the_staged_words(dev, entries, chunk_bits):
    words, wbits, aff, dD, inc, pfx = (t.to(dev) for t in _deep_stream())
    nch = -(-int(wbits[0]) // chunk_bits)
    steps = 8 if entries == "budget" else decode3._steps(chunk_bits, 8)
    kw = dict(chunk_bits=chunk_bits, steps=steps)
    if entries == "budget":
        e0 = (torch.arange(nch, dtype=torch.int32, device=dev) * chunk_bits)[None]
        ex = decode3.walk(words, e0, aff, dD, inc, pfx, wbits, records=False, **kw)[4]
        e = torch.cat([torch.zeros_like(ex[:, :1]), ex[:, :-1]], dim=1)
        assert bool((e[:, 1:] < e0[:, 1:]).all())
    else:
        rng = np.random.default_rng(chunk_bits)
        e = torch.from_numpy(rng.integers(0, int(wbits[0]), (1, nch)).astype(np.int32)).to(dev)
    got = decode3.walk(words, e, aff, dD, inc, pfx, wbits, **kw)
    want = decode3.walk_plain(words, e, aff, dD, inc, pfx, wbits, **kw)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


# arbitrary int32 tables through derive_walk_tables (as test_torch_decode
# feeds them): wrapping index sums, lengths up to 31 bits, a stream with no
# length present; the kernel builds its first-level table from them
@pytest.mark.parametrize("seed", [5, 6])
def test_walk_on_random_tables_matches_plain(dev, seed):
    words, wbits, _, _, _, pfx = _walk_inputs([_smooth(40, 64, s) for s in range(2)], dev)
    rng = np.random.default_rng(seed)
    raf = rng.integers(-(2**31), 2**31, (2, 10, 32)).astype(np.int32)
    rpr = (rng.random((2, 10, 32)) < 0.4).astype(np.int32)
    rpr[:, 4] = 0
    rib = rng.integers(-(2**31), 2**31, (2, 10, 32)).astype(np.int32)
    aff, dD, inc = decode3.derive_walk_tables(*(torch.from_numpy(a).to(dev) for a in (raf, rpr, rib)))
    chunk_bits = 512
    nch = -(-int(wbits.max()) // chunk_bits)
    e = (torch.arange(nch, dtype=torch.int32, device=dev) * chunk_bits).expand(2, nch).contiguous()
    kw = dict(chunk_bits=chunk_bits, steps=decode3._steps(chunk_bits, 8))
    got = decode3.walk(words, e, aff, dD, inc, pfx, wbits, **kw)
    want = decode3.walk_plain(words, e, aff, dD, inc, pfx, wbits, **kw)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.parametrize("K,B,M", [(4, 2, 3000), (1, 1, 1), (4, 8, 100_003)])
def test_value_join_matches_plain(dev, K, B, M):
    rng = np.random.default_rng(M)
    bins = rng.integers(-3, 1100, (K, B, M)).astype(np.int32)
    tbl = rng.integers(0, 2**16, (B, C.TOTAL_SYMBOLS)).astype(np.int32)
    bins_d, tbl_d = torch.from_numpy(bins).to(dev), torch.from_numpy(tbl).to(dev)
    before = cuda_ops.LAUNCHES["value_join"]
    _same(cuda_ops.value_join(bins_d, tbl_d), cuda_ops.value_join_plain(bins_d, tbl_d))
    assert cuda_ops.LAUNCHES["value_join"] == before + 1


def _slot_call(rows, dev, view=None):
    """slot_assemble on the card against slot_assemble_plain on the CPU's
    copy; returns the kernel's outputs.  One counted launch a call."""
    pos, sym, i12, i34, wbits, N = rows
    cpu = [torch.from_numpy(a) for a in (pos, sym, i12, i34, wbits)]
    ts = [t.to(dev) for t in cpu]
    if view is not None:
        cpu[:4] = [view(t) for t in cpu[:4]]
        ts[:4] = [view(t) for t in ts[:4]]
    want = decode3.slot_assemble_plain(*cpu, N)
    before = cuda_ops.LAUNCHES["slot_assemble"]
    got = cuda_ops.slot_assemble(*ts, n_pixels=N)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["slot_assemble"] == before + 1
    assert len(got) == len(want) == 6
    for g, w, name in zip(got, want, ("sym", "i12", "i34", "start", "live", "ok_cov")):
        assert g.device.type == "cuda" and g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.cpu(), w), name
    return got


@pytest.mark.parametrize("case", SLOT_CASES)
@pytest.mark.parametrize("B,steps", [(1, 256), (8, 256), (1, 1376), (8, 1376)])
def test_slot_assemble_matches_plain(dev, case, B, steps):
    """Random and adversarial walk records at both rungs' steps: every
    output equal, K included."""
    _slot_call(slot_records(case, B, 37, steps, seed=B * steps), dev)


@pytest.mark.parametrize("steps", [256, 13])
def test_slot_assemble_on_views(dev, steps):
    """A transposed (not contiguous) view, copied by the wrapper, and a
    contiguous one starting one element in (no 16-byte loads), and a ragged
    step count (scalar loads)."""
    pos, sym, i12, i34, wbits, N = slot_records("walk", 2, 20, steps, seed=steps)
    swapped = [np.ascontiguousarray(a.transpose(0, 2, 1)) for a in (pos, sym, i12, i34)]
    _slot_call((*swapped, wbits, N), dev, view=lambda t: t.transpose(1, 2))
    _slot_call((pos, sym, i12, i34, wbits, N), dev,
               view=lambda t: torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape))


def test_slot_assemble_across_scan_tiles(dev):
    """More chunks an image than a tile of the per-image pass (512), digit
    chains over prefix-free chunks across its boundary, N inside a chunk."""
    pos, sym, i12, i34, wbits, _ = slot_records("chains", 2, 1300, 256, seed=4)
    sym[:, 500:530] = C.PREFIX_RUN_BASE + 3
    for N in (10**12, int(2.5e6), 700_001):
        _slot_call((pos, sym, i12, i34, wbits, N), dev)


@pytest.mark.parametrize("steps", [256, 1376])
def test_slot_assemble_memory_within_slot_bytes(dev, steps):
    """The call's peak, with the records it reads, stays within SLOT_BYTES
    a slot: scratch a chunk, no (B, S) temporary."""
    pos, sym, i12, i34, wbits, _ = slot_records("walk", 8, 400, steps, seed=1)
    sym %= C.PREFIX_RUN_BASE  # prefixes only: every valid slot is real, K near its largest
    ts = [torch.from_numpy(a).to(dev) for a in (pos, sym, i12, i34, wbits)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = cuda_ops.slot_assemble(*ts, n_pixels=10**12)
    torch.cuda.synchronize()
    slots = ts[0].numel()
    assert int(out[4].sum()) > slots // 2
    records_bytes = 16 * slots
    assert torch.cuda.max_memory_allocated() - base + records_bytes <= decode3.SLOT_BYTES * slots


def test_decode_core_runs_the_kernel_and_no_torch_scan(dev):
    """api.decode_batch assembles its slots through the kernels, once a
    rung and device batch, with no torch nonzero, cummax or cumsum."""
    from torch.profiler import ProfilerActivity, profile

    imgs = [_smooth(48, 64, s) for s in range(3)]
    datas = [oracle.encode_native(im) for im in imgs]
    nicetpu_torch.decode_batch(datas, device="cuda")
    cuda_ops.reset_launches()
    stats = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = nicetpu_torch.decode_batch(datas, device="cuda", stats=stats)
        torch.cuda.synchronize()
    assert all(np.array_equal(o, im) for o, im in zip(out, imgs))
    assert cuda_ops.LAUNCHES["slot_assemble"] == 1 + stats["retries"] > 0
    names = {e.key for e in prof.key_averages()}
    assert not names & {"aten::nonzero", "aten::cummax", "aten::cumsum"}, names


CLUSTER_WIDTHS = (4352, 5000, 8192, 16384, 29051)  # past one block's shared memory (4,288 on an H100)
SCRATCH_WIDTH = 70_000  # past a 16-CTA cluster's (62,976)


def _recon_launch(dev, W, fn):
    """fn() launches one reconstruction at width W: check that it counts
    one launch, on a cluster exactly where the dispatch picks one, and
    return its result."""
    ctas = recon.cluster_ctas(W, dev)
    assert (ctas > 0) == (W in CLUSTER_WIDTHS)
    before = dict(cuda_ops.LAUNCHES)
    got = fn()
    assert cuda_ops.LAUNCHES["reconstruct_rows"] == before["reconstruct_rows"] + 1
    assert cuda_ops.LAUNCHES["reconstruct_rows_cluster"] == before["reconstruct_rows_cluster"] + (ctas > 0)
    return got


# widths 4 and 20 (the smallest and the golden rasters'), a ragged width, the
# main path's width at 64 rows (B = 1 and 8), 1100 (35 segments, the last one
# ragged: the two-level resolve), 4096 (128 segments), on one block; 4352,
# 5000, 8192, 16384 and 29,051 past one block's shared memory, on a cluster
# a chain (every size the dispatch picks; at 29,051 the ragged last segment
# and slices of 56 or 57 segments, 8 groups); 70,000 past a 16-CTA
# cluster's, on one block with device-memory scratch (2,188 segments make
# 137 groups, more than a 1,024-thread block has warps, so a warp composes
# several)
@pytest.mark.parametrize("B,H,W", [(1, 9, 4), (2, 7, 20), (3, 5, 37), (1, 64, 512), (8, 64, 512),
                                   (2, 5, 1100), (1, 3, 4096), (1, 2, 4352), (1, 2, 5000), (2, 2, 8192),
                                   (1, 2, 16384), (1, 2, 29051), (1, 1, SCRATCH_WIDTH)])
def test_reconstruct_rows_matches_plain(dev, B, H, W):
    ctas, scratch = recon.chain_plan(W, dev)
    assert (scratch > 0) == (W >= SCRATCH_WIDTH) == (ctas == 0)
    form, delta, refoff = (t.to(dev) for t in recon_random_inputs(B, H, W, seed=W))
    stats = {}
    got = _recon_launch(dev, W, lambda: recon.reconstruct_rows(form, delta, refoff, width=W, stats=stats))
    _same(got, decode_dev.reconstruct_rows(form, delta, refoff, H * W, W))
    assert stats == {"recon_chains": 3 * B, "recon_cluster_chains": 3 * B if ctas > 1 else 0}


def test_reconstruct_rows_widths_take_every_cluster_size(dev):
    """The widths above take every cluster size the dispatch can pick."""
    sizes = {recon.cluster_ctas(w, dev) for w in range(4096, SCRATCH_WIDTH + 64, 32)}
    assert {0, 8, 16} <= sizes
    assert sizes == {recon.cluster_ctas(w, dev) for w in (4096, *CLUSTER_WIDTHS)}


# CONST references, lag 2 and lag 3 on every column within 4 of a segment
# boundary (every slice seam) and of the row's ends (the wrap), each CONST
# offset in turn; with zeros and with a random carry above the block
@pytest.mark.parametrize("W", CLUSTER_WIDTHS)
@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
def test_reconstruct_rows_seams_match_plain(dev, W, carry):
    H = 3
    form, delta, refoff = (t.to(dev) for t in recon_seam_inputs(1, H, W, seed=W + 11))
    if not carry:
        got = _recon_launch(dev, W, lambda: recon.reconstruct_rows(form, delta, refoff, width=W))
        _same(got, decode_dev.reconstruct_rows(form, delta, refoff, H * W, W))
        return
    prev4 = torch.from_numpy(np.random.default_rng(W + 1).integers(0, 256, (1, 3, 4 * W))
                             .astype(np.int32)).to(dev)
    got = _recon_launch(dev, W, lambda: recon.reconstruct_rows(form, delta, refoff, width=W, prev4=prev4))
    _same(got, decode_dev.reconstruct_rows(form, delta, refoff, H * W, W, prev4=prev4))


def test_roundtrip_and_decode_on_the_card(dev):
    imgs = [_smooth(48, 64, s) for s in range(3)] + [_smooth(20, 36, 9)]
    stats = {}
    cuda_ops.reset_launches()
    datas, verified = nicetpu_torch.roundtrip_batch(imgs, device="cuda", stats=stats)
    assert datas == [oracle.encode_native(im) for im in imgs]
    assert verified.all()
    assert stats["fallbacks"] == 0 and stats["overflow_fallbacks"] == 0
    # the walk's tables come with the rest, in one launch a batch; one card
    # stitches nothing
    assert all(n > 0 for k, n in cuda_ops.LAUNCHES.items()
               if k not in ("reconstruct_rows_cluster", "walk_tables", "stitch"))
    assert cuda_ops.LAUNCHES["reconstruct_rows_cluster"] == 0  # rows this narrow fit one block
    assert cuda_ops.LAUNCHES["stitch"] == 0
    assert cuda_ops.LAUNCHES["walk_tables"] == 0
    dstats = {}
    cuda_ops.reset_launches()
    out = nicetpu_torch.decode_batch(datas, device="cuda", stats=dstats)
    assert all(np.array_equal(o, im) for o, im in zip(out, imgs))
    assert dstats["fallbacks"] == 0
    # one launch a same-shape batch (two shapes), for both rungs
    assert cuda_ops.LAUNCHES["decode_tables"] == 2 and cuda_ops.LAUNCHES["walk_tables"] == 0


# ---------------------------------------------------------------------------
# the kernels' shard offsets and carry, and the sharded codec on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_bits,n", [(512, 4), (4096, 3)])
def test_walk_shard_offsets_match_plain_and_the_unsharded_walk(dev, chunk_bits, n):
    """Each shard's walk over its slice of the words, re-based to the
    slice's first bit (`shard_walk`), equals its plain version and the
    unsharded walk's chunks for the same entries, positions shifted; the
    same slice re-based past 2**31 gives the same records; entries before a
    slice (clamped reads) equal the plain version."""
    img = _smooth(96, 128, 3)
    data = oracle.encode_native(img)
    (words, wbits, af, pr, ib, pfx, _), _ = decode3.prepare_batch_args([data], device=dev)
    aff, dD, inc = decode3.derive_walk_tables(af, pr, ib)
    tables = (aff, dD, inc, pfx)
    total = int(wbits[0])
    cfg = decode3.WalkCfg(chunk_bits, 8, 3, 3)
    nlc, steps = sharded_decode.shard_geometry(total, n, cfg)
    payload = data[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(data) - 4]
    full = torch.cat([torch.from_numpy(sharded_decode.shard_words(payload, d, nlc, chunk_bits)
                                       .view(np.int32)[: nlc * chunk_bits // 32]) for d in range(n)])
    full = torch.cat([full, torch.zeros(decode3._wrows(chunk_bits), dtype=torch.int32)])[None].to(dev)
    e = (torch.arange(n * nlc, dtype=torch.int32, device=dev) * chunk_bits)[None]
    kw = dict(chunk_bits=chunk_bits, steps=steps)
    ex = decode3.walk(full, e, aff, dD, inc, pfx, wbits, records=False, **kw)[4]
    e = torch.cat([torch.zeros_like(ex[:, :1]), ex[:, :-1]], dim=1).contiguous()
    whole = decode3.walk(full, e, aff, dD, inc, pfx, wbits, **kw)
    far = (2**31 // chunk_bits + 1) * chunk_bits
    for d in range(n):
        c0, base = d * nlc, d * nlc * chunk_bits
        sl = torch.from_numpy(sharded_decode.shard_words(payload, d, nlc, chunk_bits).view(np.int32))
        sl = sl[None].to(dev)
        ed = e[:, c0 : c0 + nlc].to(torch.int64)
        skw = dict(kw, span=nlc * chunk_bits)
        recs, exits = sharded_decode.shard_walk(sl, ed, tables, total, base=base, **skw)
        rel = (ed - base).to(torch.int32).contiguous()
        wb_rel = torch.tensor([min(total - base, nlc * chunk_bits)], dtype=torch.int32, device=dev)
        _same((*recs, (exits - base).to(torch.int32)),
              decode3.walk_plain(sl, rel, aff, dD, inc, pfx, wb_rel, **kw))
        pos_w = whole[0][:, c0 : c0 + nlc]
        _same((*recs, exits), (torch.where(pos_w >= 0, pos_w - base, -1),
                               *(r[:, c0 : c0 + nlc] for r in whole[1:4]),
                               whole[4][:, c0 : c0 + nlc].to(torch.int64)))
        recs_far, exits_far = sharded_decode.shard_walk(sl, ed + far, tables, total + far,
                                                        base=base + far, **skw)
        _same((*recs_far, exits_far), (*recs, exits + far))
        before = rel.clone()
        before[0, 0] -= 700  # 22 words before the slice on shards past the first
        _same(decode3.walk(sl, before, aff, dD, inc, pfx, wb_rel, **kw),
              decode3.walk_plain(sl, before, aff, dD, inc, pfx, wb_rel, **kw))


@pytest.mark.parametrize("B,H,W", [(2, 9, 20), (1, 12, 512), (2, 6, 1100), (1, 2, 4352), (1, 2, 5000),
                                   (1, 2, 8192), (1, 3, 16384), (1, 2, 29051), (1, 1, SCRATCH_WIDTH)])
def test_reconstruct_rows_carry_matches_plain(dev, B, H, W):
    """Kernel with a random carry against its plain version: one block in
    shared memory (20, 512, 1100 wide), a cluster a chain (4352 to 29,051)
    and one block with device-memory scratch (70,000)."""
    form, delta, refoff = (t.to(dev) for t in recon_random_inputs(B, H, W, seed=W + 3))
    prev4 = torch.from_numpy(np.random.default_rng(W).integers(0, 256, (B, 3, 4 * W))
                             .astype(np.int32)).to(dev)
    got = _recon_launch(dev, W, lambda: recon.reconstruct_rows(form, delta, refoff, width=W, prev4=prev4))
    _same(got, decode_dev.reconstruct_rows(form, delta, refoff, H * W, W, prev4=prev4))


# 16384: a rank's rows of the four-card raster, on a cluster a chain
@pytest.mark.parametrize("W,rows", [(512, (16, 16, 32)), (5000, (1, 2)), (16384, (2, 1, 3))])
def test_reconstruct_rows_blocks_chained_on_the_card(dev, W, rows):
    H = sum(rows)
    form, delta, refoff = (t.to(dev) for t in recon_random_inputs(1, H, W, seed=W))
    whole = recon.reconstruct_rows(form, delta, refoff, width=W)
    carry = torch.zeros(1, 3, 4 * W, dtype=torch.int32, device=dev)
    outs, r0 = [], 0
    for h in rows:
        cut = slice(r0 * W, (r0 + h) * W)
        out, carry = recon.reconstruct_rows(form[:, cut].contiguous(), delta[:, :, cut].contiguous(),
                                            refoff[:, cut].contiguous(), width=W, prev4=carry)
        outs.append(out)
        r0 += h
    assert torch.equal(torch.cat(outs, dim=2), whole)


@pytest.mark.parametrize("n,backend", [(2, "gloo"), (1, "nccl")])
def test_dryrun_multichip_on_the_card(dev, n, backend):
    """The sharded round trip over spawned ranks on the card: gloo ranks
    share it, NCCL runs at world size 1 on a single card."""
    res = launch.dryrun_multichip(n, backend, "cuda", timeout=300)
    for rank, r in enumerate(res):
        unlaunched = {k for k, v in r["launches"].items() if v == 0}
        # a rank whose shard holds runs only has no real slot to join
        # (sharded_decode); the walk's tables come with the decode tables;
        # the sharded decode assembles its slots with its own carried scans;
        # rank 0 alone stitches the file, once; its rows fit one block
        assert unlaunched == ({"reconstruct_rows_cluster", "walk_tables", "slot_assemble"}
                              | (set() if r["real_slots"] else {"value_join"})
                              | (set() if rank == 0 else {"stitch"})), r
        assert r["launches"]["stitch"] == (rank == 0)


@pytest.mark.parametrize("hlen", HEADER_LENGTHS)
@pytest.mark.parametrize("case", list(STITCH_CASES))
def test_stitch_kernel_matches_plain(dev, case, hlen):
    bits, k = STITCH_CASES[case]
    words, head = stitch_shards(bits, k, seed=hlen), stitch_header(hlen, seed=len(case))
    before = cuda_ops.LAUNCHES["stitch"]
    got = cuda_ops.stitch_file(words.to(dev), bits, head)
    assert got.device.type == "cuda" and cuda_ops.LAUNCHES["stitch"] == before + 1
    assert torch.equal(got.cpu(), cuda_ops.stitch_file(words, bits, head))


def test_stitch_kernel_skips_the_bits_past_a_shards_total(dev):
    bits, k = STITCH_CASES["under-32-between"]
    dirty = stitch_shards(bits, k, seed=5, garbage=True).to(dev)
    clean = stitch_shards(bits, k, seed=5)
    assert torch.equal(cuda_ops.stitch_file(dirty, bits, stitch_header(770)).cpu(),
                       cuda_ops.stitch_file(clean, bits, stitch_header(770)))


def test_stitch_kernel_at_the_four_card_cells_size(dev):
    """Four shards of about 14.3 M words (a 16384^2 raster's over four
    ranks), seeded totals near each shard's capacity: the bytes equal the
    plain version's.  Totals past the words' capacity raise before any
    launch."""
    k = 14_300_000
    bits = random_bits(4, k, seed=11)
    words = stitch_shards(bits, k, seed=11)
    want = cuda_ops.stitch_file(words, bits, stitch_header(770))
    got = cuda_ops.stitch_file(words.to(dev), bits, stitch_header(770))
    assert got.numel() == 770 + int(bits.sum()) // 8 + 5 and torch.equal(got.cpu(), want)
    before = cuda_ops.LAUNCHES["stitch"]
    with pytest.raises(ValueError, match="word capacity"):
        cuda_ops.stitch_file(words[:, : k - 200].contiguous().to(dev), bits, stitch_header(770))
    assert cuda_ops.LAUNCHES["stitch"] == before


@pytest.mark.parametrize("every_card", [False, True], ids=["one-card", "every-card"])
def test_shard_group_on_the_card(dev, every_card):
    """The persistent shard group on the cards: one NCCL rank on cuda:0,
    and one a card over every card there is.  Bytes equal hostref's, the
    cards' proof and pixels exact, and every rank's stages timed by its
    CUDA events."""
    n = torch.cuda.device_count() if every_card else 1
    img = launch.dryrun_image(8)
    img[20:37] = img[19, -1]  # a run across the shard edges
    with nicetpu_torch.api.ShardGroup(n, device="cuda", timeout=300) as g:
        for _ in range(2):
            stats: dict = {}
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks = [("call_start", ev)]
            cuda_ops.reset_launches()
            data, verified, out = g.roundtrip(img, stats=stats, keep_decoded=True, marks=marks)
            assert data == oracle.encode_native(img) and verified is True
            # rank 0 (this process) wrote the file with the stitch kernel, once
            assert cuda_ops.LAUNCHES["stitch"] == 1 and stats["device_stitches"] == 1
            np.testing.assert_array_equal(out, img)
            assert stats["host_served"] == 0 and len(stats["ranks"]) == n
            assert {"upload", "scatter", "walk", "carry_wait", "verify"} <= {m[0] for m in marks}
            for r in stats["ranks"]:
                assert r["peak_device_bytes"] > 0 and r["stage_ms"]["recon"] >= 0


# ---------------------------------------------------------------------------
# the schedulers, the CLI and the corpus on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gpu_threads,cpu_threads", [(1, 0), (3, 0), (2, 1)])
def test_roundtrip_hybrid_on_the_card(dev, gpu_threads, cpu_threads):
    """Worker threads on streams of their own: results complete, in order
    and exact, the launch counts exact under concurrent launches."""
    host = [[_smooth(48, 64, 10 * b + s) for s in range(3)] for b in range(6)]
    batches = [(b, pipeline.upload_batch(b, dev)) for b in host] + [([_smooth(20, 36, 99)], None)]
    cuda_ops.reset_launches()
    res, stats = pipeline.roundtrip_hybrid(batches, gpu_threads=gpu_threads, cpu_threads=cpu_threads)
    assert stats["gpu_batches"] + stats["cpu_batches"] == 7 and stats["cpu_batches"] >= 1
    assert cpu_threads > 0 or stats["gpu_batches"] == 6
    assert stats["fallbacks"] == 0 and stats["overflow_fallbacks"] == 0
    for out, (b, _) in zip(res, batches):
        assert [d for d, _ in out] == [oracle.encode_native(im) for im in b]
        assert all(np.array_equal(a, im) for (_, a), im in zip(out, b))
    n = stats["gpu_batches"]
    per_batch = [k for k in cuda_ops.LAUNCHES
                 if k not in ("walk", "reconstruct_rows_cluster", "walk_tables", "stitch")]
    assert {k: cuda_ops.LAUNCHES[k] for k in per_batch} == {k: n for k in per_batch}
    assert cuda_ops.LAUNCHES["walk"] == 2 * n + stats["retries"]
    assert cuda_ops.LAUNCHES["walk_tables"] == 0 and cuda_ops.LAUNCHES["stitch"] == 0
    assert cuda_ops.LAUNCHES["reconstruct_rows_cluster"] == 0


def test_an_exception_in_a_gpu_worker_fails_the_call(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("injected kernel bug")

    host = [[_smooth(20, 36, s)] for s in range(4)]
    batches = [(b, pipeline.upload_batch(b, dev)) for b in host]
    monkeypatch.setattr(cuda_ops, "fold_records", boom)
    with pytest.raises(AssertionError, match="injected kernel bug"):
        pipeline.roundtrip_hybrid(batches, gpu_threads=2, cpu_threads=1)


def test_pipeline_on_the_card(dev):
    imgs = [_smooth(48, 64, s) for s in range(9)] + [_smooth(20, 36, s) for s in range(3)]
    want = [oracle.encode_native(im) for im in imgs]
    with pipeline.Pipeline(config=RuntimeConfig(batch_size=4, workers=3)) as p:
        # on the card the pool's default width is the measured one, not config.workers
        assert p.device == torch.device("cuda") and p.workers == pipeline.Pipeline.DEVICE_WORKERS
    with pipeline.Pipeline(workers=3, config=RuntimeConfig(batch_size=4)) as p:
        assert p.workers == p._pool._max_workers == 3
        p.warmup(imgs)
        cuda_ops.reset_launches()
        assert p.encode_many(imgs) == want
        assert cuda_ops.LAUNCHES["fold_records"] == 4  # sub-batches of 4, 4, 1 and 3 images
        pairs = p.roundtrip_many(imgs)
    assert [d for d, _ in pairs] == want
    assert all(np.array_equal(a, im) for (_, a), im in zip(pairs, imgs))


def test_cli_and_corpus_on_the_card(dev, tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    monkeypatch.delenv("NICETPU_BACKEND", raising=False)
    img = _smooth(48, 64, 5)
    png = str(tmp_path / "in.png")
    nicetpu_torch.imwrite(png, img)
    cuda_ops.reset_launches()
    assert cli.main([png, str(tmp_path / "out")]) == 0  # the default backend: the card
    data = (tmp_path / "out.nice").read_bytes()
    assert data == oracle.encode_native(img)
    assert cli.main([str(tmp_path / "out.nice"), str(tmp_path / "back.png")]) == 0
    assert np.array_equal(nicetpu_torch.imread(str(tmp_path / "back.png")), img)
    # the CLI encodes through the two-step encode, whose Huffman tables are
    # built on the host; its decode builds the walk's tables with the rest;
    # one card stitches nothing
    assert [k for k, n in cuda_ops.LAUNCHES.items() if n == 0] == ["reconstruct_rows_cluster", "huffman_tables",
                                                                  "walk_tables", "stitch"]

    res = corpus.encode_corpus([png, str(tmp_path / "missing.png")], str(tmp_path / "enc"))
    assert (res.encoded, res.failed) == (1, 1)
    assert (tmp_path / "enc" / "in.nice").read_bytes() == data
    before = cuda_ops.LAUNCHES["histogram"]
    stats = corpus.stats_from_bitstream(data)
    assert cuda_ops.LAUNCHES["histogram"] == before + 1
    assert stats == corpus.stats_from_bitstream(data, device="cpu")
    assert nicetpu_torch.encode(img, config=RuntimeConfig(backend="native")) == data


@pytest.mark.parametrize("entry", ["decode_batch", "roundtrip_batch"])
def test_spans_stay_off_the_device_timeline(dev, monkeypatch, entry):
    """A profiled call records the program's spans as host ranges ("nt:"):
    none of them reaches the device's timeline, and the call makes as many
    device events as with the spans switched off."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nicetpu_torch.utils import profiling

    imgs = [_smooth(48, 64, s) for s in range(3)]
    args = [oracle.encode_native(im) for im in imgs] if entry == "decode_batch" else imgs
    fn = getattr(nicetpu_torch, entry)
    fn(args, device="cuda")

    def profiled():
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(args, device="cuda")
            torch.cuda.synchronize()
        events = prof.events()
        device = [e.name for e in events if e.device_type == DeviceType.CUDA]
        host = {e.name for e in events if e.device_type != DeviceType.CUDA}
        return device, host, profiling.spans(t0)

    on, host_on, spans_on = profiled()
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: False)
    off, host_off, spans_off = profiled()
    assert f"nt:api.{entry}" in host_on and not any(n.startswith("nt:") for n in host_off)
    assert spans_on.spans and not spans_off.spans
    assert not [n for n in on if n.startswith("nt:")]
    assert len(on) == len(off) > 0
