"""The port's numpy reference codec (`nicetpu_torch.spec`) and its "spec"
backend against the JAX package's: the codec's `tokenize`, `histogram`,
`encode` and `decode` field by field and byte by byte, the two Huffman
decode tables it needs, `api`/`cli`/`corpus` with the "spec" backend, the
RGBA policy of `api.encode`, and that no host codec answers for an absent
card.  Every comparison is exact."""

import os

import numpy as np
import pytest
import torch

from nicetpu import api as japi
from nicetpu import cli as jcli
from nicetpu.format import constants as JC
from nicetpu.format import headers as jheaders
from nicetpu.format import huffman as jhuffman
from nicetpu.spec import codec as jcodec
from nicetpu_torch import api, cli, pipeline
from nicetpu_torch.config import RuntimeConfig
from nicetpu_torch.format import huffman as thuffman
from nicetpu_torch.hostref import oracle as toracle
from nicetpu_torch.spec import codec as tcodec

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = ["random8x6", "gradient16x12", "flat9x7", "mixed20x14"]
SPEC = RuntimeConfig(backend="spec")


def _golden(name):
    img = np.load(os.path.join(DATA, f"{name}.npy"))
    with open(os.path.join(DATA, f"{name}.nice"), "rb") as f:
        return img, f.read()


def _levels(seed, h, w):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 5, (h, w, 1)) * 50 + rng.integers(0, 4, (h, w, 3))).astype(np.uint8)


def _long_run():
    """A run of 700 pixels (four base-8 digits) across rows, then a run to
    the end of the image."""
    img = _levels(3, 40, 32)
    img[5, 7:] = img[5, 6]
    img[6:27] = img[5, 6]
    img[27, :3] = img[5, 6]
    img[35:] = img[34, -1]
    return img


def _crossing():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    img[2, 3:] = img[2, 2]
    img[3, :2] = img[2, 2]
    return img


SEEDED = {
    "noise": lambda: np.random.default_rng(0).integers(0, 256, (16, 8, 3), dtype=np.uint8),
    "levels": lambda: _levels(1, 24, 32),
    "constant": lambda: np.full((10, 7, 3), 200, np.uint8),
    "one_row": lambda: np.random.default_rng(1).integers(0, 256, (1, 5, 3), dtype=np.uint8),
    "run_past_512": _long_run,
    "run_across_rows": _crossing,
}
IMAGES = {**{n: (lambda n=n: _golden(n)[0]) for n in GOLDEN}, **SEEDED}


# ---------------------------------------------------------------------------
# the codec, against nicetpu.spec.codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_tokenize_and_histogram_match_field_by_field(name):
    img = IMAGES[name]()
    got, want = tcodec.tokenize(img), jcodec.tokenize(img)
    assert type(got).__name__ == type(want).__name__ == "TokenPlan"
    for field in ("streams", "symbols", "valid"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_array_equal(tcodec.histogram(got), jcodec.histogram(want))


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_encode_bytes_and_decode_match(name):
    img = IMAGES[name]()
    data = tcodec.encode(img)
    assert data == jcodec.encode(img)
    if name in GOLDEN:
        assert data == _golden(name)[1]
    np.testing.assert_array_equal(tcodec.decode(data), img)


@pytest.mark.parametrize("name", GOLDEN)
def test_decode_of_the_golden_files(name):
    img, data = _golden(name)
    out = tcodec.decode(data)
    np.testing.assert_array_equal(out, jcodec.decode(data))
    np.testing.assert_array_equal(out, img)
    assert out.dtype == np.uint8 and out.shape == img.shape


def _deep_stream(img):
    """`img` encoded with deep RGB-stream codes (Fibonacci counts on 45
    symbols, clamped to 31 bits): any complete tables encode any tokens, so the stream is
    valid and takes the decoder's LUT-free canonical path."""
    plan = jcodec.tokenize(img)
    counts = jcodec.histogram(plan)
    base, size = JC.STREAM_BASE[JC.SC_RGB], JC.ALPHABET_SIZES[JC.SC_RGB]
    fib = [1, 1]
    while len(fib) < 45:
        fib.append(fib[-1] + fib[-2])
    counts[base : base + size] = 1
    counts[base : base + 45] = fib
    lengths, codes, max_aobs = jhuffman.build_all_tables(counts)
    assert max_aobs[JC.SC_RGB] > 16
    H, W, _ = img.shape
    return (jheaders.pack_file_header(W, H, 3) + jheaders.pack_stream_headers(lengths)
            + jcodec.pack_payload(plan, lengths, codes))


def test_decode_of_deep_codes_matches():
    img = _levels(4, 12, 16)
    data = _deep_stream(img)
    np.testing.assert_array_equal(tcodec.decode(data), jcodec.decode(data))
    np.testing.assert_array_equal(tcodec.decode(data), img)


@pytest.mark.parametrize("corrupt", ["kraft", "width"])
def test_corrupt_streams_raise_alike(corrupt):
    _, data = _golden("mixed20x14")
    if corrupt == "kraft":
        flat = jheaders.parse_stream_headers(data[JC.FILE_HEADER_BYTES :]).copy()
        flat[JC.STREAM_BASE[JC.SC_RGB]] += 1
        bad = data[: JC.FILE_HEADER_BYTES] + jheaders.pack_stream_headers(flat) + data[
            JC.FILE_HEADER_BYTES + JC.STREAM_HEADERS_BYTES :]
        with pytest.raises(ValueError) as want:
            jcodec.decode(bad)
        with pytest.raises(ValueError) as got:
            tcodec.decode(bad)
        assert str(got.value) == str(want.value)
    else:
        for c in (tcodec, jcodec):
            with pytest.raises(ValueError, match="width"):
                c.encode(np.zeros((4, 3, 3), np.uint8))


def _lengths_sets():
    """Code lengths of every stream of the golden files, and deep ones."""
    out = {}
    for name in GOLDEN:
        flat = jheaders.parse_stream_headers(_golden(name)[1][JC.FILE_HEADER_BYTES :])
        for s in (JC.SC_PREFIXES, JC.SC_RGB, JC.SC_BACK_REF):
            b = JC.STREAM_BASE[s]
            out[f"{name}-{s}"] = flat[b : b + JC.ALPHABET_SIZES[s]]
    fib = [1, 1]
    while len(fib) < 20:
        fib.append(fib[-1] + fib[-2])
    out["fib20"] = jhuffman.code_lengths(np.asarray(fib[:20]))  # 19 bits: LUT of 2^19
    out["chain30"] = np.asarray(list(range(1, 31)) + [30], np.uint8)  # past MAX_LUT_AOB
    return out


LENGTHS = _lengths_sets()


@pytest.mark.parametrize("name", sorted(LENGTHS))
def test_decode_table_copies_match_original(name):
    lens = LENGTHS[name]
    for g, w in zip(thuffman.canonical_decode_tables(lens), jhuffman.canonical_decode_tables(lens)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    codes = jhuffman.canonical_codes(lens)
    if int(lens.max()) > JC.MAX_LUT_AOB:
        for h in (thuffman, jhuffman):
            with pytest.raises(OverflowError):
                h.decode_lut(lens, codes)
        return
    for g, w in zip(thuffman.decode_lut(lens, codes), jhuffman.decode_lut(lens, codes)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# api, cli, corpus with the "spec" backend
# ---------------------------------------------------------------------------


def test_api_spec_backend_matches_the_jax_api(monkeypatch):
    imgs = [IMAGES[n]() for n in ("mixed20x14", "levels", "run_past_512", "gradient16x12")]
    jst, st = {}, {}
    want = japi.encode_batch(imgs, backend="spec", stats=jst)
    assert api.encode_batch(imgs, config=SPEC, stats=st) == want
    assert st == jst == {"backend": "spec"}
    for im, w in zip(imgs, want):
        assert api.encode(im, config=SPEC) == japi.encode(im, backend="spec") == w
        np.testing.assert_array_equal(api.decode(w, config=SPEC), japi.decode(w, backend="spec"))
    jst, st = {}, {}
    jout = japi.decode_batch(want, backend="spec", stats=jst)
    out = api.decode_batch(want, config=SPEC, stats=st)
    assert st == jst == {"backend": "spec"}
    for o, jo, im in zip(out, jout, imgs):
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(o, im)
    monkeypatch.setenv("NICETPU_BACKEND", "spec")
    st = {}
    assert api.encode_batch(imgs[:1], stats=st) == want[:1] and st == {"backend": "spec"}


def test_spec_backend_runs_the_numpy_codec_and_nothing_else(monkeypatch):
    """The spec backend is served by `spec.codec` alone: neither the C++
    host codec nor a device path answers."""

    def refuse(*a, **kw):
        raise AssertionError("another codec answered for the spec backend")

    for name in ("encode_native", "encode_batch_native", "decode_native", "decode_batch_native"):
        monkeypatch.setattr(toracle, name, refuse)
    monkeypatch.setattr(api.encode2, "encode_batch", refuse)
    monkeypatch.setattr(api.decode3, "decode_batch_v3", refuse)
    img = IMAGES["levels"]()
    data = api.encode(img, config=SPEC)
    assert data == jcodec.encode(img)
    np.testing.assert_array_equal(api.decode_batch([data], config=SPEC)[0], img)


def test_an_absent_card_raises_and_no_host_codec_answers(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the card is present: a request for it is served")
    monkeypatch.delenv("NICETPU_BACKEND", raising=False)

    def refuse(*a, **kw):
        raise AssertionError("a host codec answered for the card")

    monkeypatch.setattr(api, "_host_encode", refuse)
    monkeypatch.setattr(api, "_host_decode", refuse)
    for mod, names in ((tcodec, ("encode", "decode")),
                       (toracle, ("encode_batch_native", "decode_batch_native"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    img, data = _golden("mixed20x14")
    for call in (lambda: api.encode(img), lambda: api.encode(img, config=RuntimeConfig(backend="cuda")),
                 lambda: api.encode_batch([img], device="cuda"), lambda: api.decode(data),
                 lambda: api.decode_batch([data], config=RuntimeConfig(backend="cuda"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_pipeline_has_no_spec_backend():
    with pytest.raises(ValueError, match="spec"):
        pipeline.Pipeline(config=SPEC)


def test_rgba_policy_of_encode_matches_jax():
    rgba = np.concatenate([_levels(5, 12, 16), np.full((12, 16, 1), 9, np.uint8)], axis=2)
    with pytest.raises(ValueError) as want:
        japi.encode(rgba, backend="spec", alpha="error")
    for kw in ({"config": SPEC}, {"device": "cpu"}, {"config": RuntimeConfig(backend="native")}):
        with pytest.raises(ValueError) as got:
            api.encode(rgba, alpha="error", **kw)
        assert str(got.value) == str(want.value)
        assert api.encode(rgba, **kw) == api.encode(rgba, alpha="drop", **kw) == japi.encode(
            rgba, backend="spec", alpha="drop")
        with pytest.raises(ValueError, match="unknown alpha policy"):
            api.encode(rgba, alpha="keep", **kw)
    # the policy applies to RGBA only
    assert api.encode(rgba[..., :3], config=SPEC, alpha="error") == japi.encode(rgba[..., :3], backend="spec")


def test_cli_spec_backend_both_ways_like_the_jax_cli(tmp_path, capsys):
    img = IMAGES["levels"]()
    png = str(tmp_path / "in.png")
    japi.imwrite(png, img)
    assert cli.main([png, str(tmp_path / "t.nice"), "--backend", "spec"]) == 0
    assert jcli.main([png, str(tmp_path / "j.nice"), "--backend", "spec"]) == 0
    data = (tmp_path / "t.nice").read_bytes()
    assert data == (tmp_path / "j.nice").read_bytes() == jcodec.encode(img)
    assert cli.main([str(tmp_path / "t.nice"), str(tmp_path / "back.png"), "--backend", "spec"]) == 0
    assert jcli.main([str(tmp_path / "j.nice"), str(tmp_path / "jback.png"), "--backend", "spec"]) == 0
    np.testing.assert_array_equal(api.imread(str(tmp_path / "back.png")), img)
    np.testing.assert_array_equal(api.imread(str(tmp_path / "jback.png")), img)
    assert "decode:" in capsys.readouterr().out
