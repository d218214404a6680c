"""config, the CLI and the streamed corpus of nicetpu_torch against the JAX
package's, on the same environment variables, PNG files and golden rasters.
Bytes, pixels and counts: every comparison is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from nicetpu import api as japi
from nicetpu import cli as jcli
from nicetpu import corpus as jcorpus
from nicetpu.config import RuntimeConfig as JRuntimeConfig
from nicetpu.spec import codec
import nicetpu_torch
from nicetpu_torch import api, cli, corpus
from nicetpu_torch.config import RuntimeConfig

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = ["random8x6", "gradient16x12", "flat9x7", "mixed20x14"]
SHARED_FIELDS = ("backend", "batch_size", "workers", "omp_threads", "verbose")

def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is present: a request for it is served")


def _img(seed=0, h=24, w=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 5, (h, w, 1)) * 50 + rng.integers(0, 4, (h, w, 3))).astype(np.uint8)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_from_env_matches_the_jax_config_on_the_shared_fields(monkeypatch):
    monkeypatch.setenv("NICETPU_BACKEND", "native")
    monkeypatch.setenv("NICETPU_BATCH_SIZE", "8")
    monkeypatch.setenv("NICETPU_WORKERS", "3")
    monkeypatch.setenv("NICETPU_OMP_THREADS", "2")
    monkeypatch.setenv("NICETPU_VERBOSE", "true")
    cfg, jcfg = RuntimeConfig.from_env(workers=2), JRuntimeConfig.from_env(workers=2)
    for f in SHARED_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.backend, cfg.batch_size, cfg.workers, cfg.omp_threads, cfg.verbose) == (
        "native", 8, 2, 2, True)


def test_defaults_and_the_fields_left_out(monkeypatch):
    for f in SHARED_FIELDS:
        monkeypatch.delenv(f"NICETPU_{f.upper()}", raising=False)
    cfg, jcfg = RuntimeConfig.from_env(), JRuntimeConfig.from_env()
    assert cfg.backend == "cuda" and cfg.batch_size == api.MAX_BATCH
    assert (cfg.workers, cfg.omp_threads, cfg.verbose) == (jcfg.workers, jcfg.omp_threads, jcfg.verbose)
    assert not hasattr(cfg, "compilation_cache")


def test_unknown_field_rejected_with_the_same_error():
    with pytest.raises(ValueError, match="unknown config field 'bogus'"):
        RuntimeConfig.from_env(bogus=1)
    with pytest.raises(ValueError, match="unknown config field 'bogus'"):
        JRuntimeConfig.from_env(bogus=1)


def test_apply_sets_the_omp_threads_and_no_jax_variable(monkeypatch):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    RuntimeConfig(omp_threads=0).apply()
    assert "OMP_NUM_THREADS" not in os.environ
    RuntimeConfig(omp_threads=3).apply()
    assert os.environ["OMP_NUM_THREADS"] == "3"
    assert "JAX_COMPILATION_CACHE_DIR" not in os.environ


@pytest.mark.parametrize("backend", ["auto", "jax", "tpu"])
def test_backends_of_the_jax_package_are_refused(backend):
    with pytest.raises(ValueError, match="unknown backend"):
        api.encode(_img(), config=RuntimeConfig(backend=backend))


def test_cuda_backend_without_cuda_raises_and_nothing_answers_in_its_place(monkeypatch):
    _needs_no_cuda()
    monkeypatch.delenv("NICETPU_BACKEND", raising=False)
    img, data = _img(), codec.encode(_img())
    calls = (
        lambda: api.encode(img, config=RuntimeConfig(backend="cuda")),
        lambda: api.encode_batch([img], config=RuntimeConfig()),
        lambda: api.decode(data, config=RuntimeConfig(backend="cuda")),
        lambda: api.decode_batch([data]),
        lambda: corpus.stats_from_bitstream(data),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_config_supplies_the_backend_where_no_device_is_given(monkeypatch):
    imgs = [_img(1), _img(2, 8, 16)]
    want = [codec.encode(im) for im in imgs]
    stats = {}
    assert api.encode_batch(imgs, config=RuntimeConfig(backend="native"), stats=stats) == want
    assert stats == {"backend": "native"}
    stats = {}
    assert api.encode_batch(imgs, config=RuntimeConfig(backend="cpu"), stats=stats) == want
    assert stats == {"device": "cpu", "overflow_fallbacks": 0, "retokenized": 0, "slot_mode": 0}
    # an explicit device wins over the config; the environment is read last
    assert api.encode(imgs[0], device="cpu", config=RuntimeConfig(backend="cuda")) == want[0]
    monkeypatch.setenv("NICETPU_BACKEND", "native")
    assert api.encode(imgs[1]) == want[1]
    stats = {}
    out = api.decode_batch(want, stats=stats)
    assert stats == {"backend": "native"}
    for o, im in zip(out, imgs):
        np.testing.assert_array_equal(o, im)
    np.testing.assert_array_equal(api.decode(want[0], config=RuntimeConfig(backend="cpu")), imgs[0])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cpu", "native", "spec"])
def test_cli_writes_the_bytes_of_the_jax_cli_and_converts_back(tmp_path, capsys, backend):
    img = _img(3)
    png = str(tmp_path / "in.png")
    japi.imwrite(png, img)
    assert cli.main([png, str(tmp_path / "t.nice"), "--backend", backend, "--verbose"]) == 0
    out = capsys.readouterr().out
    assert "png read:" in out and "encode:" in out and "ratio" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert {"png_read", "encode", "write", "total_ms", "MB/s"} <= set(summary)
    assert jcli.main([png, str(tmp_path / "j.nice"), "--backend", "native"]) == 0
    data = (tmp_path / "t.nice").read_bytes()
    assert data == (tmp_path / "j.nice").read_bytes() == codec.encode(img)

    assert cli.main([str(tmp_path / "t.nice"), str(tmp_path / "back.png"), "--backend", backend]) == 0
    out = capsys.readouterr().out
    assert "decode:" in out and "png write:" in out
    np.testing.assert_array_equal(api.imread(str(tmp_path / "back.png")), img)
    np.testing.assert_array_equal(japi.imread(str(tmp_path / "back.png")), img)


def test_cli_suffix_rules_and_exit_code_2(tmp_path, capsys):
    img = _img(4, 8, 12)
    png = str(tmp_path / "a.png")
    nicetpu_torch.imwrite(png, img)
    assert cli.main([png, str(tmp_path / "noext"), "--backend", "native"]) == 0
    assert (tmp_path / "noext.nice").exists() and not (tmp_path / "noext").exists()
    assert cli.main([str(tmp_path / "noext.nice"), str(tmp_path / "img"), "--backend", "native"]) == 0
    assert (tmp_path / "img.png").exists()
    capsys.readouterr()
    for argv in ([str(tmp_path / "a.txt"), str(tmp_path / "x.nice")],
                 [str(tmp_path / "a"), str(tmp_path / "x.png"), "--backend", "cpu"]):
        assert cli.main(argv) == jcli.main(argv[:2]) == 2
        err = capsys.readouterr().err.strip().splitlines()
        assert err == ["error: source must end in .png or .nice"] * 2
    assert not (tmp_path / "x.nice").exists() and not (tmp_path / "x.png").exists()


def test_cli_refuses_backends_it_does_not_have(tmp_path):
    for backend in ("auto", "jax"):
        with pytest.raises(SystemExit):
            cli.main([str(tmp_path / "a.png"), str(tmp_path / "a.nice"), "--backend", backend])


def test_cli_cuda_without_a_card_is_an_error_and_writes_nothing(tmp_path, capsys, monkeypatch):
    _needs_no_cuda()
    monkeypatch.delenv("NICETPU_BACKEND", raising=False)
    png = str(tmp_path / "a.png")
    nicetpu_torch.imwrite(png, _img(5, 8, 12))
    for argv in ([png, str(tmp_path / "a.nice")], [png, str(tmp_path / "b.nice"), "--backend", "cuda"]):
        assert cli.main(argv) == 1
        assert "CUDA is not available" in capsys.readouterr().err
    assert sorted(os.listdir(tmp_path)) == ["a.png"]


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------


@pytest.fixture
def png_corpus(tmp_path):
    """The four images of tests/test_corpus.py, as PNG files."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        img = (rng.integers(0, 5, (10, 12, 1)) * 50 + rng.integers(0, 4, (10, 12, 3))).astype(np.uint8)
        p = tmp_path / f"img{i}.png"
        japi.imwrite(str(p), img)
        paths.append(str(p))
    return paths, tmp_path


def _manifest(out_dir):
    with open(os.path.join(out_dir, "manifest.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("backend", ["cpu", "native", "spec"])
def test_encode_corpus_manifest_resume_and_isolation_like_jax(png_corpus, backend):
    paths, tmp = png_corpus
    bad = str(tmp / "missing.png")
    out, jout = str(tmp / "out"), str(tmp / "jout")
    res = corpus.encode_corpus(paths[:2] + [bad], out, backend=backend)
    jres = jcorpus.encode_corpus(paths[:2] + [bad], jout, backend="spec")
    res2 = corpus.encode_corpus(paths + [bad], out, backend=backend)
    jres2 = jcorpus.encode_corpus(paths + [bad], jout, backend="spec")
    for r, jr in ((res, jres), (res2, jres2)):
        got, want = vars(r).copy(), vars(jr).copy()
        got.pop("seconds"), want.pop("seconds")
        assert got == want
    assert (res.encoded, res.failed) == (2, 1)
    assert (res2.skipped, res2.encoded, res2.failed) == (2, 2, 1)

    recs, jrecs = _manifest(out), _manifest(jout)
    assert len(recs) == len(jrecs) == 6
    for r, jr in zip(recs, jrecs):
        assert r["out"] == jr["out"].replace(jout, out)
        r, jr = dict(r, out=None), dict(jr, out=None)
        assert r == jr
    for r, jr in zip(recs, jrecs):
        if r["status"] == "ok":
            with open(r["out"], "rb") as f, open(jr["out"], "rb") as jf:
                data = f.read()
                assert data == jf.read()
            np.testing.assert_array_equal(api.decode(data, device="cpu"), api.imread(r["path"]))


def test_encode_corpus_for_an_absent_card_raises_before_the_first_image(png_corpus, monkeypatch):
    _needs_no_cuda()
    monkeypatch.delenv("NICETPU_BACKEND", raising=False)
    paths, tmp = png_corpus
    for backend in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            corpus.encode_corpus(paths, str(tmp / "out"), backend=backend)
    assert not (tmp / "out").exists()
    monkeypatch.setenv("NICETPU_BACKEND", "native")
    assert corpus.encode_corpus(paths, str(tmp / "out")).encoded == 4


@pytest.mark.parametrize("name", GOLDEN)
def test_mode_stats_and_stats_from_bitstream_on_the_golden_rasters(name):
    img = np.load(os.path.join(DATA, name + ".npy"))
    with open(os.path.join(DATA, name + ".nice"), "rb") as f:
        data = f.read()
    counts = codec.histogram(codec.tokenize(img))
    want = jcorpus.mode_stats(counts)
    assert corpus.mode_stats(counts) == want
    assert jcorpus.stats_from_bitstream(data) == want
    assert corpus.stats_from_bitstream(data, device="cpu") == want
    assert corpus.stats_from_bitstream(data, config=RuntimeConfig(backend="native")) == want
    assert corpus.stats_from_bitstream(data, config=RuntimeConfig(backend="spec")) == want


def test_stats_from_bitstream_counts_a_run_of_four_digits():
    """A 767-pixel run needs four base-8 digits, one more than the fused
    encoder's slots hold: the stats still count every digit."""
    img = np.zeros((24, 32, 3), np.uint8)
    img[0, 0] = 3
    data = codec.encode(img)
    want = jcorpus.stats_from_bitstream(data)
    assert sum(want["run_digits"].values()) == 4
    assert corpus.stats_from_bitstream(data, device="cpu") == want
