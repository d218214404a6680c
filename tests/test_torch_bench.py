"""The port's bench modules (`nicetpu_torch.bench`, `bench_all`,
`bench_trace`) on the CPU, with the kernels' plain versions and tiny
images: every field of the lines, exact outputs, the degraded flag and the
null headline, the trace's idle-share arithmetic, and config 5's checks.
Config 5's rank function runs inside the 4-rank spawn of
`tests/test_torch_dist.py`."""

import functools
import json

import numpy as np
import pytest
import torch

from nicetpu_torch import (api, bench, bench_all, bench_decode_profile, bench_huffman_dev, bench_multihost,
                           bench_profile, bench_real, bench_trace, pipeline)

BENCH_KEYS = {
    "metric", "value", "value_fastest", "value_slowest", "unit", "gpu_share", "gpu_batches",
    "baseline_native_mbs", "baseline_native_mbs_fastest", "baseline_native_mbs_slowest",
    "vs_baseline", "device_only", "device_only_fastest", "device_only_slowest", "device_roundtrip",
    "device_roundtrip_fastest", "device_roundtrip_slowest", "decode_device_e2e",
    "decode_device_e2e_fastest", "decode_device_e2e_slowest", "decode_device",
    "decode_device_fastest", "decode_device_slowest", "ratio", "counts", "degraded", "reps",
    "images", "batch", "side", "device", "card",
}
SECTIONS = {"hybrid", "device_only", "device_roundtrip", "decode_device_e2e", "decode_device"}


def test_bench_line_on_the_cpu():
    line = bench.run("cpu", n_images=4, batch=2, side=32, reps=1, device_batches=2, card="cpu")
    assert set(line) == BENCH_KEYS
    assert set(line["counts"]) == SECTIONS
    assert all(c == dict.fromkeys(bench.COUNTS, 0) for c in line["counts"].values())
    assert line["degraded"] is False
    assert line["gpu_batches"] == [1] and line["gpu_share"] == 0.5  # one batch from each end
    for key in BENCH_KEYS - {"metric", "unit", "counts", "degraded", "device", "card", "gpu_batches"}:
        assert line[key] is not None and line[key] > 0, key
    assert line["vs_baseline"] == line["value"] / line["baseline_native_mbs"]
    assert (line["reps"], line["images"], line["device"]) == (1, 4, "cpu")


def test_hybrid_sweep_on_the_cpu():
    """The hybrid section alone at each count of GPU workers, in turn."""
    line = bench.hybrid_sweep("cpu", gpu_threads=(1, 2), n_images=4, batch=2, side=32, reps=2, card="cpu")
    assert set(line["by_gpu_threads"]) == {"1", "2"}
    for r in line["by_gpu_threads"].values():
        assert r["value_slowest"] <= r["value"] <= r["value_fastest"]
        assert len(r["gpu_batches"]) == 2 and all(1 <= g <= 2 for g in r["gpu_batches"])
    assert set(line["counts"]) == {"hybrid_1", "hybrid_2"} and line["degraded"] is False
    assert (line["reps"], line["device"], line["card"]) == (2, "cpu", "cpu")


def _host_batches(n=4, batch=2, side=32):
    imgs = [bench.make_image(side, side, s) for s in range(n)]
    from nicetpu_torch.hostref import oracle

    hb = [imgs[i : i + batch] for i in range(0, n, batch)]
    return imgs, [oracle.encode_native(im) for im in imgs], hb


def test_no_device_batch_gives_a_null_headline(monkeypatch):
    """Where the host workers take every batch, value is null."""
    imgs, refs, hb = _host_batches()
    host_only = functools.partial(pipeline.roundtrip_hybrid, gpu_threads=0, cpu_threads=1)
    monkeypatch.setattr(pipeline, "roundtrip_hybrid", host_only)
    counts: dict = {}
    out = bench._hybrid([(b, None) for b in hb], hb, imgs, refs, 1, torch.device("cpu"), counts)
    assert out["value"] is None and out["value_fastest"] is None and out["value_slowest"] is None
    assert out["gpu_batches"] == [0] and out["gpu_share"] == 0
    assert not bench.degraded(counts)


def test_a_counted_fallback_marks_the_run_degraded(monkeypatch):
    imgs, refs, hb = _host_batches()
    real = pipeline.roundtrip_hybrid

    def one_fallback(batches, **kw):
        results, stats = real(batches, gpu_threads=0, cpu_threads=1, **kw)
        stats["fallbacks"] += 1
        return results, stats

    monkeypatch.setattr(pipeline, "roundtrip_hybrid", one_fallback)
    counts: dict = {}
    bench._hybrid([(b, None) for b in hb], hb, imgs, refs, 1, torch.device("cpu"), counts)
    assert counts["hybrid"]["fallbacks"] == 1
    assert bench.degraded(counts)
    assert bench.degraded({"a": {"fallbacks": 0, "overflow_fallbacks": 2}})
    assert not bench.degraded({"a": {"fallbacks": 0, "overflow_fallbacks": 0}})


def test_a_wrong_blob_fails_the_bench(monkeypatch):
    imgs, refs, hb = _host_batches()
    monkeypatch.setattr(pipeline, "roundtrip_hybrid",
                        functools.partial(pipeline.roundtrip_hybrid, gpu_threads=0, cpu_threads=1))
    with pytest.raises(AssertionError, match="hostref"):
        bench._hybrid([(b, None) for b in hb], hb, imgs, refs[::-1], 1, torch.device("cpu"), {})


CONFIG_ARGS = {
    1: dict(side=32, reps=1),
    2: dict(n=2, h=16, w=24, reps=1),
    3: dict(side=32, real_side=32, reps=1),
    4: dict(n=2, lo=8, hi=24, reps=1),
}
CONFIG_LINES = {1: 1, 2: 4, 3: 4, 4: 2}


@pytest.mark.parametrize("config", sorted(CONFIG_ARGS))
def test_bench_all_config_on_the_cpu(config):
    lines = bench_all.CONFIGS[config](torch.device("cpu"), card="cpu", **CONFIG_ARGS[config])
    assert len(lines) == CONFIG_LINES[config]
    for ln in lines:
        assert ln["config"].startswith(f"{config}: ")
        assert {"config", "value", "unit", "note", "fastest", "slowest", "verified", "fallbacks",
                "degraded", "reps", "card"} <= set(ln)
        assert ln["verified"] is True and ln["fallbacks"] == 0 and ln.get("overflow_fallbacks", 0) == 0
        assert ln["degraded"] is False
        assert ln["value"] > 0 and ln["unit"] == "MB/s" and ln["reps"] == 1
    if config == 2:
        assert all("real photo patches" in ln["config"] for ln in lines)
    if config == 4:  # texture cuts, the device line one api.roundtrip_batch of every shape
        assert all("photo texture patches" in ln["config"] for ln in lines)
        n = CONFIG_ARGS[4]["n"]
        assert lines[1]["device_batches"] == -(-n // api.MAX_BATCH)
    if config == 3:
        assert all("peak_device_gib" in ln for ln in lines[:3])
        assert lines[1]["verified_on_device"] is True
        assert all("32x32 real photo (soccer0)" in ln["config"] for ln in lines[2:])
        assert all(ln["gates"] == [[True] * 4] for ln in lines[2:])


REAL_KEYS = {"image", "shape", "ratio", "native_rt_mbs", "native_rt_mbs_fastest",
             "native_rt_mbs_slowest", "device_enc_mbs", "device_enc_mbs_fastest",
             "device_enc_mbs_slowest", "device_fastpath", "reps", "card"}


def test_bench_real_on_the_cpu(capsys):
    """bench_real.main over the corpus centre-cropped to 16 x 16: a line an
    image with its fields, in the corpus's order, and the summary."""
    from nicetpu_torch import realcorpus

    assert bench_real.main(["--device", "cpu", "--max-dim", "16", "--reps", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["image"] for ln in lines[:-1]] == list(realcorpus.NAMES)
    for ln in lines[:-1]:
        assert set(ln) - {"bits_match"} == REAL_KEYS and ln["shape"] == "16x16"
        assert ln["device_fastpath"] is True and ln["bits_match"] is True
        assert ln["ratio"] > 0 and ln["native_rt_mbs"] > 0 and ln["device_enc_mbs"] > 0
    summary = lines[-1]
    assert set(summary) == {"summary", "images", "overall_ratio", "device_fastpath_rate", "card"}
    assert summary["images"] == 8 and summary["device_fastpath_rate"] == 1.0
    raw = 8 * 16 * 16 * 3
    nice = sum(raw / 8 / ln["ratio"] for ln in lines[:-1])
    assert summary["overall_ratio"] == pytest.approx(raw / nice)


def test_bench_real_flags_an_overflow_and_refuses_a_bits_mismatch(monkeypatch, capsys):
    """An overflowing encode leaves the fast path (no bits_match); a total
    that differs from the native stream's exits non-zero."""
    from nicetpu_torch.kernels import encode2

    real = encode2.encode_fused
    calls = []

    def fake(*args, **kw):
        words, small = real(*args, **kw)
        calls.append(1)
        if len(calls) <= 2:  # the first image's warm-up and timed call overflow
            small[:, 859] = 1
        else:  # the others' totals are a byte off the native streams'
            small[:, 858] += 8
        return words, small

    monkeypatch.setattr(encode2, "encode_fused", fake)
    assert bench_real.main(["--device", "cpu", "--max-dim", "16", "--reps", "1"]) == 1
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["device_fastpath"] is False and "bits_match" not in lines[0]
    assert lines[1]["device_fastpath"] is True and lines[1]["bits_match"] is False
    assert lines[-1]["device_fastpath_rate"] == 7 / 8


def _rank(rank, **change):
    r = {"rank": rank, "bytes": 3, "sha256": bench_all.hashlib.sha256(b"abc").hexdigest(),
         "raster_equal": True, "encode_stats": {"overflow_fallbacks": 0},
         "decode_stats": {"fallbacks": 0},
         "launches": {"walk": 2, "value_join": 1, "reconstruct_rows": 1}}
    r.update(change)
    return r


@pytest.mark.parametrize("bad,match", [
    (dict(sha256="0" * 64), "bytes differ"),
    (dict(raster_equal=False), "raster differs"),
    (dict(decode_stats={"fallbacks": 1}), "fell back"),
    (dict(launches={"walk": 2, "value_join": 0, "reconstruct_rows": 1}), "skipped"),
])
def test_config5_check_refuses_a_bad_rank(bad, match):
    bench_all.config5_check([_rank(0), _rank(1)], b"abc", on_card=True)
    with pytest.raises(AssertionError, match=match):
        bench_all.config5_check([_rank(0), _rank(1, **bad)], b"abc", on_card=True)


@pytest.mark.parametrize("intervals,lo,hi,busy", [
    ([], 0, 10, 0.0),
    ([(0, 2), (1, 3), (5, 6)], 0, 10, 4.0),  # overlap
    ([(1, 9), (2, 3), (4, 5)], 0, 10, 8.0),  # nested
    ([(-5, 1), (9, 20)], 0, 10, 2.0),  # clipped to the window
    ([(11, 12), (-3, -1)], 0, 10, 0.0),  # outside the window
    ([(0, 10), (3, 4)], 0, 10, 10.0),  # always busy
])
def test_trace_idle_share_arithmetic(intervals, lo, hi, busy):
    assert bench_trace.union_ms(intervals, lo, hi) == busy
    assert bench_trace.idle_share(intervals, lo, hi) == pytest.approx(1 - busy / (hi - lo))


def test_trace_top_ops_sum_by_name():
    rows = [("a", 1.0), ("b", 5.0), ("a", 2.5), ("c", 0.5), ("b" * 300, 0.25)]
    top = bench_trace.top_ops(rows, n=2)
    assert top == [{"name": "b", "total_ms": 5.0, "count": 1}, {"name": "a", "total_ms": 3.5, "count": 2}]
    assert len(bench_trace.top_ops(rows)[-1]["name"]) == bench_trace.NAME_CHARS


@pytest.mark.parametrize("module", [bench, bench_all, bench_real, bench_trace, bench_huffman_dev,
                                    bench_profile, bench_decode_profile, bench_multihost])
def test_the_benches_exit_1_without_cuda(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    assert module.main([]) == 1
    assert "cuda" in capsys.readouterr().err.lower()


HUFFMAN_KEYS = {"B", "side", "raw_mb", "fused_bits", "twostep_bits", "device_tables_win", "reps",
                "device", "card"} | {
    f"{path}_{unit}{end}" for path in ("fused", "twostep") for unit in ("ms", "mb_s")
    for end in ("", "_fastest", "_slowest")}


def test_bench_huffman_dev_on_the_cpu(capsys):
    """The fused and the two-step encode of one small batch: every key of
    the line, equal bits, bytes checked against hostref inside the run."""
    assert bench_huffman_dev.main(["--device", "cpu", "--side", "32", "--sizes", "2", "--reps", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1 and set(lines[0]) == HUFFMAN_KEYS
    ln = lines[0]
    assert (ln["B"], ln["side"], ln["reps"], ln["device"]) == (2, 32, 1, "cpu")
    assert ln["fused_bits"] == ln["twostep_bits"] > 0
    assert ln["device_tables_win"] == (ln["fused_ms"] < ln["twostep_ms"])
    assert ln["fused_mb_s"] == pytest.approx(ln["raw_mb"] / (ln["fused_ms"] / 1e3))


def test_bench_huffman_dev_refuses_a_bits_mismatch(monkeypatch):
    from nicetpu_torch.kernels import encode2

    real = encode2.encode_resident

    def one_bit_more(*a, **kw):
        words, totals, lengths = real(*a, **kw)
        return words, totals + 1, lengths

    monkeypatch.setattr(encode2, "encode_resident", one_bit_more)
    with pytest.raises(AssertionError, match="payload bits differ"):
        bench_huffman_dev.run("cpu", sizes=(1,), side=16, reps=1, card="test")


def test_make_img_is_built_in_blocks_of_rows(monkeypatch):
    whole = bench_all.make_img(40, 24, 5, rgba=True)
    monkeypatch.setattr(bench_all, "MAKE_IMG_ROWS", 7)
    np.testing.assert_array_equal(bench_all.make_img(40, 24, 5, rgba=True), whole)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_config5_line_from_the_ranks_records(monkeypatch, device):
    """config5_run's line from its ranks' records (the spawn replaced by
    made-up records): MB/s over the slowest rank, the payload bits, the
    per-rank peaks and stages; on the card the peak is the largest of all
    ranks' encode and decode peaks."""
    from nicetpu_torch.dist import launch
    from nicetpu_torch.hostref import oracle
    from nicetpu_torch.kernels.decode3 import payload_bits

    side = 16
    ref = oracle.encode_native(bench_all.make_img(side, side, bench_all.CONFIG5_SEED))
    peak = (lambda r, k: 1.0 + r + k) if device == "cuda" else (lambda r, k: None)

    def fake_run(fn, n, **kw):
        assert fn is bench_all.config5_rank and kw["args"][0] == side
        return [_rank(r, bytes=len(ref), sha256=bench_all.hashlib.sha256(ref).hexdigest(),
                      payload_bits=payload_bits(ref), encode_s=1.0 + r, decode_s=2.0,
                      encode_stats={"overflow_fallbacks": 0, "stages": {"pack": 0.5}},
                      decode_stats={"fallbacks": 0, "stages": {"recon": 0.25}},
                      encode_peak_device_gib=peak(r, 0.5), decode_peak_device_gib=peak(r, 0),
                      peak_rss_gib=0.5) for r in range(n)]

    monkeypatch.setattr(launch, "run", fake_run)
    line, img, got_ref = bench_all.config5_run(torch.device(device), side=side, card="test")
    assert got_ref == ref and img.shape == (side, side, 3)
    mb = img.nbytes / 1e6
    assert line["encode_mbs"] == line["value"] == mb / 4.0 and line["decode_mbs"] == mb / 2.0
    assert line["payload_bits"] == payload_bits(ref) and line["side"] == side
    assert [r["encode_stages"] for r in line["ranks"]] == [{"pack": 0.5}] * 4
    assert line["peak_device_gib"] == (4.5 if device == "cuda" else None)
    assert line["verified"] is True and line["fallbacks"] == 0 and line["backend"] == "gloo"


def test_rung_probe_on_the_cpu(capsys):
    """The rung probe's single-device lines: each rung's gates, equality
    and peak (none on the CPU); a stream past the limit is skipped."""
    from nicetpu_torch import rung_probe

    assert rung_probe.main(["--height", "16", "--width", "24", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["rung"] for ln in lines] == [0, 1]
    for ln in lines:
        assert ln["gates"] == dict.fromkeys(rung_probe.GATES, True) and ln["equal"] is True
        assert ln["peak_device_gib"] is None and ln["raster"] == "make_img(16, 24, 5)"


def test_rung_probe_skips_a_stream_past_the_limit(monkeypatch):
    from nicetpu_torch import rung_probe
    from nicetpu_torch.hostref import oracle
    from nicetpu_torch.kernels import decode3

    img = bench_all.make_img(8, 8, 5)
    monkeypatch.setattr(decode3, "MAX_DEVICE_BITS", 8)
    out = rung_probe.single_device(torch.device("cpu"), img, oracle.encode_native(img))
    assert len(out) == 1 and out[0]["skipped"] == "past MAX_DEVICE_BITS"
