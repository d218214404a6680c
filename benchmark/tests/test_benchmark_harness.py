"""The harness on the CPU: files found by name, the run's refusals, the
generators, the metric arithmetic and the import check."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import _tiny
from benchmark import corpus, run, trace
from benchmark.calls import decode_batch, encode_batch, roundtrip_batch
from benchmark.content import corpus_patches, screenshot
from benchmark.spec import Spec

REPO = _tiny.REPO
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = _tiny.make(str(tmp_path_factory.mktemp("tiny")))
    return Spec(root, os.path.join(root, "benchmark"))


@pytest.fixture(scope="module")
def pixels():
    return corpus.load(REPO, ["wood", "marble", "skin", "soccer0"])


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric added as new files, with
    new entries in BENCHMARK.json, run without an edit to any file."""
    root = _tiny.make(str(tmp_path))
    folder = os.path.join(root, "benchmark")
    with open(os.path.join(folder, "configs", "kodak24.json")) as f:
        cfg = json.load(f)
    cfg.update(name="minipatch", per_call=4)
    with open(os.path.join(folder, "configs", "minipatch.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(folder, "traffic", "ingest_again.json"), "w") as f:
        json.dump({"call": "encode_batch", "why": "t"}, f)
    with open(os.path.join(folder, "metrics", "host.images_per_call.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.images / ctx.calls\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "minipatch", "source": "https://r0k.us/graphics/kodak/",
                             "file": "benchmark/configs/minipatch.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "minipatch-ingest", "config": "minipatch",
                               "traffic": "ingest_again", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "host.images_per_call", "unit": "images", "better": "higher",
                               "source": "program_counter", "layer": "host", "moves": "raw_MBps",
                               "workloads": ["minipatch-ingest"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    spec = Spec(root, folder)
    r = run.run_cell(spec, "minipatch-ingest", SEED, 0.2, True, device="cpu")
    assert r["correct"] and r["metrics"]["host.images_per_call"]["value"] == 4.0
    r = run.run_cell(spec, "minipatch-ingest", SEED, 0.2, False, device="cpu")
    # a metric with a list of cells reports in those alone
    assert r["correct"] and set(r["metrics"]) == {"raw_MBps", "setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", ["kodak24-decode", "kodak24-encode", "kodak24-roundtrip",
                                  "raster4096-roundtrip"])
def test_every_cell_runs_correct_at_a_tiny_size(tiny, cell):
    r = run.run_cell(tiny, cell, SEED, 0.1, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["checks"]["images_checked"]["value"] >= 1 and r["failed"] == 0
    assert r["metrics"]["raw_MBps"]["value"] > 0 and r["metrics"]["setup_s"]["value"] > 0


def test_traced_run_reads_the_program_counters(tiny):
    r = run.run_cell(tiny, "kodak24-encode", SEED, 0.1, True, device="cpu")
    assert r["correct"] and "breakdown" in r and r["device"]["window_s"] > 0
    # no device on the CPU: no device metric reads a number
    assert not {"device.idle_pct", "device.ops_per_call", "kernels.roofline_pct"} & set(r["metrics"])


def _run_cmd(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "kodak24-encode",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_run_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run_cmd(REPO)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's folder alone
    holds no program: no result."""
    import shutil

    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    p = _run_cmd(str(tmp_path), env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout == ""


def test_corpus_pins_refuse_a_changed_file(tmp_path):
    pins = corpus.pins()
    d = tmp_path / pins["dir"]
    d.mkdir(parents=True)
    for name in pins["sha256"]:
        data = open(os.path.join(REPO, pins["dir"], f"{name}.nice"), "rb").read()
        if name == "marble":
            data = data[:-1] + bytes([data[-1] ^ 1])
        (d / f"{name}.nice").write_bytes(data)
    with pytest.raises(RuntimeError, match="marble"):
        corpus.verify(str(tmp_path))
    assert set(corpus.verify(REPO)) == set(pins["sha256"])


def test_corpus_pixels_are_the_files_decoded(pixels):
    from nicetpu_torch import realcorpus
    from nicetpu_torch.hostref import oracle

    for name, img in pixels.items():
        assert np.array_equal(img, oracle.decode_native(realcorpus.read_bytes(name))), name


def test_patches_are_deterministic_and_the_same_work_every_seed(pixels):
    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs", "kodak24.json")))
    a, b = corpus_patches.make(cfg, SEED, pixels), corpus_patches.make(cfg, SEED, pixels)
    c = corpus_patches.make(cfg, SEED + 1, pixels)
    assert len(a) == cfg["pool"] and all(p.shape == (512, 768, 3) for p in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    # the same patches, flipped and in another order
    sums = lambda pool: sorted(int(p.astype(np.int64).sum()) for p in pool)  # noqa: E731
    assert sums(a) == sums(c)


def test_screenshots_are_deterministic(tiny, pixels):
    cfg = tiny.config("raster4096")
    a, b = screenshot.make(cfg, SEED, pixels), screenshot.make(cfg, SEED, pixels)
    c = screenshot.make(cfg, -SEED, pixels)
    assert len(a) == cfg["pool"] and a[0].shape == (192, 192, 4) and (a[0][..., 3] == 255).all()
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], a[1])


def _ctx(latencies_ms, raw=1_000_000):
    ctx = run.Ctx(device=torch.device("cpu"))
    t = 10.0
    for ms in latencies_ms:
        ctx.records.append(run.Record([0, 1], t, t + ms / 1e3, raw, 2 * raw))
        t += ms / 1e3
    ctx.t0, ctx.t1 = 10.0, t
    return ctx


def test_p95_is_over_every_call_and_the_rate_over_the_window():
    lat = list(range(1, 101))  # ms
    ctx = _ctx(lat)
    p95 = Spec(REPO).module("metrics", "call_p95_ms").read(ctx)
    assert p95 == pytest.approx(95.05)
    rate = Spec(REPO).module("metrics", "raw_MBps").read(ctx)
    assert rate == pytest.approx(100 * 1.0 / (sum(lat) / 1e3))
    ctx.records[3].error = "RuntimeError: x"
    assert Spec(REPO).module("metrics", "raw_MBps").read(ctx) == pytest.approx(99 / (sum(lat) / 1e3))


def test_union_gaps_and_device_metrics():
    assert trace.union([(0, 2), (1, 3), (5, 6), (-1, 0.5)], 0, 5.5) == pytest.approx(3.5)
    assert trace.gaps([(1, 2), (1.5, 3), (4, 9)], 0, 5) == [(0, 1), (3, 4)]
    ops = [("k1", 0.0, 2.0), ("k2", 1.0, 3.0), ("k1", 6.0, 7.0)]
    hosts = [("bench:encode2.assemble", 2.5, 6.5), ("aten::copy_", 4.0, 5.5)]
    s = trace.Summary(ops, hosts, 0.0, 10.0, calls=2, work_bytes=3_350_000)
    assert s.busy_s == pytest.approx(4e-6) and s.window_s == pytest.approx(1e-5)
    assert s.top_ops == [["k1", pytest.approx(3e-6)], ["k2", pytest.approx(2e-6)]]
    assert s.idle_gaps[0] == ["encode2.assemble / aten::copy_", pytest.approx(3e-6)]
    ctx = _ctx([1.0])
    ctx.trace, ctx.card = s, "NVIDIA H100 80GB HBM3"
    ctx.peaks = json.load(open(os.path.join(REPO, "benchmark", "peaks.json")))
    spec = Spec(REPO)
    assert spec.module("metrics", "device.idle_pct").read(ctx) == pytest.approx(60.0)
    assert spec.module("metrics", "device.ops_per_call").read(ctx) == pytest.approx(1.5)
    # 3.35 MB at 3.35 TB/s is 1 us of the 4 us busy
    assert spec.module("metrics", "kernels.roofline_pct").read(ctx) == pytest.approx(25.0)
    ctx.card = "some other card"
    assert spec.module("metrics", "kernels.roofline_pct").read(ctx) is None


def test_stage_means_and_fallback_share():
    ctx = _ctx([1.0, 1.0])
    spec = Spec(REPO)
    assert spec.module("metrics", "decode3.assemble_ms").read(ctx) is None
    ctx.stage_ms = {"assemble": 9.0, "fetch+assembly": 3.0, "host_tables": 1.0}
    assert spec.module("metrics", "decode3.assemble_ms").read(ctx) == 4.5
    assert spec.module("metrics", "pipeline.fetch_assembly_ms").read(ctx) == 1.5
    assert spec.module("metrics", "encode2.host_tables_ms").read(ctx) == 0.5
    assert spec.module("metrics", "decode3.fallback_pct").read(ctx) is None
    ctx.stats = {"fallbacks": 1, "overflow_fallbacks": 2}
    assert spec.module("metrics", "decode3.fallback_pct").read(ctx) == pytest.approx(75.0)


def test_least_bytes_are_counted_from_the_work():
    img = np.zeros((4, 5, 4), np.uint8)
    assert decode_batch.work_bytes(img, b"x" * 100, None) == 160
    assert encode_batch.work_bytes(img, img, b"y" * 30) == 90
    assert roundtrip_batch.work_bytes(img, img, (b"y" * 30, True, True)) == 180


def test_round_trip_judges_the_pixels_its_device_decoded(tiny):
    """A watched call's answers carry, for each image, whether a rung's
    decoded planes equal it; an unwatched call's carry nothing."""
    cfg = tiny.config("kodak24")
    pool = corpus_patches.make(cfg, SEED, corpus.load(REPO, corpus_patches.corpus_names(cfg["content"])))
    program = roundtrip_batch.Program(torch.device("cpu"), pool)
    program.watch([2, 0])
    watched = program.call([pool[2], pool[0]], {})
    program.watch(None)
    assert [a[1:] for a in watched] == [(True, True), (True, True)]
    assert [a[2] for a in program.call([pool[1], pool[3]], {})] == [None, None]
    # the planes of another image are not this one's
    program.watch([1, 0])
    program.capture(torch.from_numpy(np.stack([p.reshape(-1, 3).T for p in (pool[1], pool[1])])))
    assert program.captured[-1].tolist() == [True, False]
    program.watch(None)
    d = roundtrip_batch.digest(watched[0])
    assert not roundtrip_batch.wrong(d, d[0])
    assert roundtrip_batch.wrong((d[0], True, False), d[0]) and roundtrip_batch.wrong((d[0], True, None), d[0])
    assert not roundtrip_batch.wrong((d[0], False, None), d[0])


def test_reference_encodes_are_cached_by_their_pixels(tmp_path, monkeypatch):
    from benchmark import jobs

    monkeypatch.setattr(jobs, "CACHE", str(tmp_path / "ref"))
    imgs = [np.full((4, 8, 3), v, np.uint8) for v in (3, 200)]
    first = jobs.encode(imgs, REPO)
    assert len(os.listdir(tmp_path / "ref")) == 2

    def no_run(*args, **kwargs):
        raise AssertionError("the reference ran again")

    monkeypatch.setattr(jobs, "run", no_run)
    assert jobs.encode(imgs, REPO) == first
    monkeypatch.undo()
    monkeypatch.setattr(jobs, "CACHE", str(tmp_path / "ref"))
    other = imgs[0].copy()
    other[0, 0, 0] = 4
    assert jobs.encode([other], REPO)[0] != first[0] and len(os.listdir(tmp_path / "ref")) == 3


def test_steady_heap_sets_the_allocator():
    assert run.steady_heap() is True


def test_host_load_is_read_over_the_interval():
    cores = os.cpu_count()
    h = run.host_load((1000, 600, 1.0, 7.0), (1000 + 100 * cores, 600 + 100 * cores - 150, 1.5, 9.0))
    # 100 jiffies a core passed; 150 of 100 x cores were busy
    assert h["busy_cores"] == pytest.approx(150 / 100)
    assert h["process_cores"] == pytest.approx(0.5 / 2.0)
    assert h["cores"] == cores and len(h["loadavg"]) == 3


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert "nicetpu_torch" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nicetpu.kernels", types.ModuleType("nicetpu.kernels"))
    monkeypatch.setitem(sys.modules, "jaxlib_extra", types.ModuleType("jaxlib_extra"))
    assert "nicetpu" in run.forbidden_modules() and "jaxlib_extra" not in run.forbidden_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(REPO, "benchmark", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert not tops & {"nicetpu", "nicetpu_torch", "jax", "jaxlib", "flax", "torch"}, name


def test_benchmark_imports_no_jax_anywhere():
    for dirpath, _, files in os.walk(os.path.join(REPO, "benchmark")):
        for name in files:
            if name.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(dirpath, name))}
                assert not tops & {"nicetpu", "jax", "jaxlib", "flax"}, name


def test_benchmark_json_names_files_that_exist():
    spec = Spec(REPO)
    for c in spec.bench["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"])) and spec.config(c["name"])["name"] == c["name"]
    for w in spec.bench["workloads"]:
        traffic = spec.traffic(w["traffic"])
        spec.module("calls", traffic["call"])
        spec.module("content", spec.config(w["config"])["content"]["kind"])
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)
