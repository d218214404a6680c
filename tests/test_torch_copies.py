"""The port's own copies of framework-neutral code, held against their
originals: the format constants name by name, the header layouts, the
code-length validation, the Huffman table construction, the RGB normalisation, the native codec, the smoke
run's and the benches' test images and real-photo patches, the stage timer, the mode statistics, the PNG bridges and
the sharded codec's halo size and payload stitch."""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import bench
import bench_all
import chip_smoke
from nicetpu import api as japi
from nicetpu import corpus as jcorpus
from nicetpu.dist import sharded as jsharded
from nicetpu.format import constants as JC
from nicetpu.format import headers as jheaders
from nicetpu.format import huffman as jhuffman
from nicetpu.hostref import oracle as joracle
from nicetpu.kernels import tokenize as jtokenize
from nicetpu.utils import profiling as jprofiling
from nicetpu_torch import api as tapi
from nicetpu_torch import bench as tbench
from nicetpu_torch import bench_all as tbench_all
from nicetpu_torch import corpus as tcorpus
from nicetpu_torch.format import constants as TC
from nicetpu_torch.format import headers as theaders
from nicetpu_torch.format import huffman as thuffman
from nicetpu_torch.dist import sharded as tsharded
from nicetpu_torch.hostref import oracle as toracle
from nicetpu_torch.kernels import huffman_dev as thuffman_dev
from nicetpu_torch.kernels import tokenize as ttokenize
from nicetpu_torch.utils import profiling as tprofiling
from test_torch_huffman_dev import _deep as deep_histograms

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = ["random8x6", "gradient16x12", "flat9x7", "mixed20x14"]


def _golden(name):
    img = np.load(os.path.join(DATA, f"{name}.npy"))
    with open(os.path.join(DATA, f"{name}.nice"), "rb") as f:
        return img, f.read()


def test_constants_match_name_by_name():
    public = lambda m: {k for k in vars(m) if not k.startswith("_") and k != "np"}
    assert public(TC) == public(JC)
    for name in sorted(public(JC)):
        a, b = getattr(JC, name), getattr(TC, name)
        if callable(a):
            for w in (4, 5, 7, 20, 512, 4096):
                assert a(w) == b(w), name
        else:
            assert a == b, name


@pytest.mark.parametrize("name", GOLDEN)
def test_headers_round_trip_like_the_original(name):
    _, data = _golden(name)
    assert theaders.parse_file_header(data) == jheaders.parse_file_header(data)
    lens = theaders.parse_stream_headers(data[TC.FILE_HEADER_BYTES :])
    np.testing.assert_array_equal(lens, jheaders.parse_stream_headers(data[JC.FILE_HEADER_BYTES :]))
    W, H, ch = theaders.parse_file_header(data)
    assert theaders.pack_file_header(W, H, ch) == jheaders.pack_file_header(W, H, ch)
    packed = theaders.pack_stream_headers(lens)
    assert packed == jheaders.pack_stream_headers(lens)
    assert data[TC.FILE_HEADER_BYTES :].startswith(packed)


def test_validate_flat_lengths_accepts_and_rejects_alike():
    _, data = _golden("mixed20x14")
    good = theaders.parse_stream_headers(data[TC.FILE_HEADER_BYTES :]).astype(np.int64)
    thuffman.validate_flat_lengths(good)
    jhuffman.validate_flat_lengths(good)
    out_of_range = good.copy()
    out_of_range[3] = 0
    kraft = good.copy()
    kraft[:256] = 7  # 256 codes of 7 bits: a Kraft sum of 2
    for bad in (out_of_range, kraft):
        for fn in (thuffman.validate_flat_lengths, jhuffman.validate_flat_lengths):
            with pytest.raises(ValueError):
                fn(bad)


def _one_live():
    counts = np.zeros(TC.TOTAL_SYMBOLS, np.int64)
    counts[TC.STREAM_BASE[TC.SC_SMALL_DIFF] + 17] = 1000
    return counts


HISTOGRAMS = {
    "zeros": lambda: np.zeros(TC.TOTAL_SYMBOLS, np.int64),
    "one_live": _one_live,
    "random": lambda: np.random.default_rng(3).integers(0, 5000, TC.TOTAL_SYMBOLS),
    # the deep-code rows of tests/test_torch_huffman_dev.py; row 1 reaches the clamp
    **{f"deep{r}": (lambda r=r: deep_histograms()[r]) for r in range(3)},
}


@pytest.mark.parametrize("name", sorted(HISTOGRAMS))
def test_huffman_table_copies_match_original(name):
    """The port's Python code-length merge equals the original stream by stream, and
    its native `build_tables_host` equals its `build_all_tables`, the
    original's tables and the on-device tables on the same counts."""
    counts = HISTOGRAMS[name]()
    for s in range(TC.NUM_STREAMS):
        sl = counts[TC.STREAM_BASE[s] : TC.STREAM_BASE[s] + TC.ALPHABET_SIZES[s]]
        assert thuffman.clamp_floor(sl.sum()) == jhuffman.clamp_floor(sl.sum())
        np.testing.assert_array_equal(thuffman._huffman_lengths_once(sl), jhuffman._huffman_lengths_once(sl))
        lens = thuffman.code_lengths(sl)
        np.testing.assert_array_equal(lens, jhuffman.code_lengths(sl))
        np.testing.assert_array_equal(thuffman.canonical_codes(lens), jhuffman.canonical_codes(lens))
    tl, tc, tmax = thuffman.build_all_tables(counts)
    jl, jc, jmax = jhuffman.build_all_tables(counts)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)
    assert tmax == jmax and max(tmax) <= TC.MAX_CODE_LEN
    hl, hc = thuffman.build_tables_host(counts)
    assert hl.dtype == np.uint8 and hc.dtype == np.uint32
    np.testing.assert_array_equal(hl, tl)
    np.testing.assert_array_equal(hc, tc)
    for want, got in zip(jhuffman.build_tables_host(counts), (hl, hc)):
        np.testing.assert_array_equal(got, want)
    dl, dc, ovf = thuffman_dev.build_tables_device(torch.from_numpy(counts[None].astype(np.int32)))
    np.testing.assert_array_equal(dl[0].numpy(), hl)
    np.testing.assert_array_equal(dc[0].numpy().view(np.uint32), hc)
    assert not bool(ovf.any())


def test_deep_histogram_reaches_the_clamp():
    """Without the clamp, the deep1 row's stream would need codes over 31 bits."""
    counts = HISTOGRAMS["deep1"]()
    raw = max(int(jhuffman._huffman_lengths_once(
        counts[TC.STREAM_BASE[s] : TC.STREAM_BASE[s] + TC.ALPHABET_SIZES[s]]).max())
        for s in range(TC.NUM_STREAMS))
    assert raw > TC.MAX_CODE_LEN


def test_build_tables_host_has_no_fallback(monkeypatch):
    """Where the native library cannot be had, the host table build raises
    (the original falls back to the Python merge)."""
    def no_lib():
        raise OSError("libniceref.so cannot be built")

    monkeypatch.setattr(toracle, "get_lib", no_lib)
    with pytest.raises(OSError):
        thuffman.build_tables_host(HISTOGRAMS["random"]())


def test_to_rgb_matches():
    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, (5, 6, 4)).astype(np.uint8)
    np.testing.assert_array_equal(tapi._to_rgb(rgba), japi._to_rgb(rgba))
    np.testing.assert_array_equal(tapi._to_rgb(rgba[..., :3]), japi._to_rgb(rgba[..., :3]))
    for bad in (rgba.astype(np.float32), rgba[..., :2]):
        with pytest.raises(ValueError):
            tapi._to_rgb(bad)
    with pytest.raises(ValueError):
        tapi._to_rgb(rgba, alpha="error")


@pytest.mark.parametrize("name", GOLDEN)
def test_hostref_copy_matches_original(name):
    img, data = _golden(name)
    assert toracle.encode_native(img) == joracle.encode_native(img) == data
    np.testing.assert_array_equal(toracle.decode_native(data), joracle.decode_native(data))
    np.testing.assert_array_equal(toracle.decode_native(data), img)


def test_hostref_copy_builds_outside_the_source_tree():
    toracle.get_lib()
    assert os.path.dirname(toracle._LIB).endswith(os.path.join("nicetpu_torch", "_build"))
    assert not os.path.exists(os.path.join(os.path.dirname(toracle._SRC), "libniceref.so"))


def test_make_image_copy_matches_bench():
    assert chip_smoke.make_image is tbench.make_image
    for h, w, seed in ((16, 24, 0), (512, 512, 7)):
        np.testing.assert_array_equal(chip_smoke.make_image(h, w, seed), bench.make_image(h, w, seed))


@pytest.mark.parametrize("h,w,seed,rgba", [(16, 24, 0, False), (300, 37, 5, False), (513, 20, 3, True),
                                           (64, 64, 5, True)])
def test_make_img_copy_matches_bench_all(h, w, seed, rgba):
    """The port's `bench_all.make_img`, built in blocks of rows, equals the
    original, RGBA included (rows past one block, and a ragged last block)."""
    got = tbench_all.make_img(h, w, seed, rgba=rgba)
    np.testing.assert_array_equal(got, bench_all.make_img(h, w, seed, rgba=rgba))
    assert got.shape == (h, w, 4 if rgba else 3) and got.dtype == np.uint8


@pytest.mark.parametrize("n,h,w", [(3, 16, 24), (10, 40, 8), (2, 300, 500), (9, 600, 700)])
def test_real_patches_copy_matches_bench_all(n, h, w):
    """The port's `real_patches`, cut from its committed corpus, equals the
    JAX bench's, cut from the images the packages ship (the camera shots
    pixel-doubled where a patch is larger)."""
    got, want = tbench_all.real_patches(n, h, w), bench_all.real_patches(n, h, w)
    assert len(got) == len(want) == n
    for g, x in zip(got, want):
        assert g.shape == (h, w, 3) and g.flags.c_contiguous
        np.testing.assert_array_equal(g, x)


def test_stage_timer_copy_matches_original(monkeypatch):
    """The same clock readings give the same stages and the same summary."""
    assert inspect.getsource(tprofiling.StageTimer) == inspect.getsource(jprofiling.StageTimer)
    summaries = []
    for mod in (tprofiling, jprofiling):
        ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        t = mod.StageTimer()
        with t.stage("a"):
            pass
        with t.stage("b"):
            pass
        with t.stage("a"):
            pass
        assert t.stages == {"a": 0.375, "b": 0.5}
        summaries.append((t.summary(), t.summary(nbytes=7_000_000)))
    assert summaries[0] == summaries[1]
    assert json.loads(summaries[0][1]) == {"a": 375.0, "b": 500.0, "total_ms": 875.0, "MB/s": 8.0}


@pytest.mark.parametrize("seed", [0, 1])
def test_mode_stats_copy_matches_original(seed):
    counts = np.random.default_rng(seed).integers(0, 1000, TC.TOTAL_SYMBOLS)
    assert tcorpus.mode_stats(counts) == jcorpus.mode_stats(counts)
    assert inspect.getsource(tcorpus.mode_stats) == inspect.getsource(jcorpus.mode_stats)
    assert [f.name for f in tcorpus.CorpusResult.__dataclass_fields__.values()] == [
        f.name for f in jcorpus.CorpusResult.__dataclass_fields__.values()]


def test_png_bridges_match(tmp_path):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    rgba = rng.integers(0, 256, (7, 9, 4)).astype(np.uint8)
    gray = rng.integers(0, 256, (7, 9)).astype(np.uint8)
    for name, img in (("rgb", rgb), ("rgba", rgba), ("gray", gray)):
        tp, jp = str(tmp_path / f"t_{name}.png"), str(tmp_path / f"j_{name}.png")
        tapi.imwrite(tp, img)
        japi.imwrite(jp, img)
        for path in (tp, jp):
            np.testing.assert_array_equal(tapi.imread(path), japi.imread(path))
        assert tapi.imread(tp).shape == (7, 9, 4 if name == "rgba" else 3)


def test_halo_pixels_copy_matches_original():
    for w in (4, 5, 12, 128, 4096):
        assert ttokenize.halo_pixels(w) == jtokenize.halo_pixels(w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stitch_payload_copy_matches_original(seed):
    """Shards of random bit lengths (empty, word-aligned and ragged) stitch
    to the same bytes and total; a shard over its capacity fails in both."""
    rng = np.random.default_rng(seed)
    n, words_per = 4, 9
    words = rng.integers(0, 2**32, n * words_per, dtype=np.uint64).astype(np.uint32)
    bits = rng.integers(0, 32 * words_per + 1, n).astype(np.int64)
    bits[seed % n] = 0
    bits[(seed + 1) % n] = 32 * (seed + 2)
    for w in range(n):  # the encoder leaves the bits past a shard's total zero
        k = int(bits[w])
        shard = words[w * words_per : (w + 1) * words_per]
        shard[k // 32 + (k % 32 > 0) :] = 0
        if k % 32:
            shard[k // 32] &= np.uint32((0xFFFFFFFF << (32 - k % 32)) & 0xFFFFFFFF)
    assert tsharded.stitch_payload(words, bits, n) == jsharded.stitch_payload(words, bits, n)
    bits[0] = 32 * words_per + 1
    for fn in (tsharded.stitch_payload, jsharded.stitch_payload):
        with pytest.raises(ValueError):
            fn(words, bits, n)
