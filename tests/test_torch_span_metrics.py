"""The benchmark's readers of the program's spans and of `overflow_decoded`
(`benchmark/metrics/`), on tiny traced runs of the harness on the CPU.

The runs use a copy of the benchmark with two cells of their own, a decode
and a round trip, on a two-image pool drawn here: one smooth image and one
whose run of 575 pixels overflows the fused encode, so that the round
trip's host route runs.  The CPU profiler records every operation of the
plain walk, so the walk's step budget is cut (a rung of 32 steps); images it
misses are decoded on the host, and the readers see the same spans.
"""

import json
import os

import pytest

from benchmark import run
from benchmark.spec import Spec
from benchmark.tests import _tiny
from nicetpu_torch.kernels import decode3

SEED = 2**31 + 19
CONTENT = '''"""Two tiny images: a smooth one and one long run (test content)."""
import numpy as np


def corpus_names(content):
    return []


def make(config, seed, corpus):
    H, W = config["shape"]["height"], config["shape"]["width"]
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (120 + 40 * np.sin(xx / 9.0) + 30 * np.cos(yy / 5.0)).astype(np.int32)
    smooth = np.stack([base, base + 7, base - 9], -1) + g.integers(-2, 3, (H, W, 3))
    flat = np.zeros((H, W, 3), np.uint8)
    flat[0, 0] = 7
    return [np.clip(smooth, 0, 255).astype(np.uint8), flat]
'''
CELLS = {"spans-decode": "decode", "spans-roundtrip": "roundtrip"}
READERS = ("decode3.prepare_ms", "decode3.fetch_ms", "pipeline.host_route_ms", "spans.root_self_ms",
           "decode3.wasted_decode_pct")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = _tiny.make(str(tmp_path_factory.mktemp("spans")))
    folder = os.path.join(root, "benchmark")
    with open(os.path.join(folder, "content", "two_tiny.py"), "w") as f:
        f.write(CONTENT)
    with open(os.path.join(folder, "configs", "kodak24.json")) as f:
        cfg = json.load(f)
    cfg.update(name="two_tiny", shape={"height": 8, "width": 72, "channels": 3}, pool=2, per_call=2,
               warmup_calls=0, trace_calls=1, content={"kind": "two_tiny"})
    with open(os.path.join(folder, "configs", "two_tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "two_tiny", "source": "test", "file": "benchmark/configs/two_tiny.json",
                             "reduced": [], "why": "t"})
    bench["workloads"] += [{"name": c, "config": "two_tiny", "traffic": t, "chips": 1, "why": "t"}
                           for c, t in CELLS.items()]
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            m["workloads"] += list(CELLS)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    spec = Spec(root, folder)
    short = decode3.WalkCfg(2048, 32, 64, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decode3, "LADDER", (short, short))
        return {c: run.run_cell(spec, c, SEED, 0.01, True, device="cpu") for c in CELLS}


@pytest.mark.parametrize("cell,metric", [
    ("spans-decode", "decode3.prepare_ms"),
    ("spans-decode", "decode3.fetch_ms"),
    ("spans-decode", "spans.root_self_ms"),
    ("spans-roundtrip", "pipeline.host_route_ms"),
    ("spans-roundtrip", "spans.root_self_ms"),
])
def test_span_readers_read_the_profiled_calls(results, cell, metric):
    r = results[cell]
    assert r["correct"], r["checks"]
    assert r["metrics"][metric]["unit"] == "ms" and r["metrics"][metric]["value"] > 0


def test_wasted_decode_reads_the_overflowed_share(results):
    r = results["spans-roundtrip"]
    assert r["metrics"]["decode3.wasted_decode_pct"] == {"value": 50.0, "unit": "%"}
    assert "decode3.wasted_decode_pct" not in results["spans-decode"]["metrics"]


@pytest.mark.parametrize("metric", READERS)
def test_readers_give_none_without_spans_or_counter(metric):
    spec = Spec(_tiny.REPO)
    reader = spec.module("metrics", metric)
    ctx = run.Ctx(device=None, stats={"fallbacks": 0})
    ctx.records.append(run.Record([0], 0.0, 1.0, 3, 3))
    assert reader.read(ctx) is None  # an untraced run, no counter
    ctx.trace = run.trace.Summary([], [], 0.0, 1.0, 1, 0)
    ctx.t1 = float("inf")  # no span starts after the window
    assert reader.read(ctx) is None
