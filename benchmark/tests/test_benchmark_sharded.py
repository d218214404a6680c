"""The `raster16k` configuration at a tiny size on the CPU: the blocked
reference against the whole-image one, the cell through the harness with
the program (a group of 4 gloo ranks), planted faults and the control,
and the reference's imports."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _tiny
from benchmark import control, run
from benchmark.reference import blocked, codec
from benchmark.spec import Spec

SEED = 2**31 + 77
CELL = "raster16k-sharded4"
# the tiny cut: a 4 x 4 grid of 16-pixel tiles, 64 x 64, 16 rows a rank
TINY = {"shape": {"height": 64, "width": 64, "channels": 3}, "warmup_calls": 1, "trace_calls": 1}
TINY_CONTENT = {"grid": 4, "tile": 16}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = _tiny.make(str(tmp_path_factory.mktemp("tiny16k")))
    path = os.path.join(root, "benchmark", "configs", "raster16k.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    cfg["content"].update(TINY_CONTENT)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return Spec(root, os.path.join(root, "benchmark"))


def _rasters():
    rng = np.random.default_rng(41)
    base = (rng.integers(0, 4, (48, 12, 1)) * 60 + rng.integers(0, 3, (48, 12, 3))).astype(np.uint8)
    yield "seeded", base
    yield "noise", rng.integers(0, 256, (29, 13, 3), dtype=np.uint8)
    edge = base.copy()
    edge[6:11] = edge[5, -1]  # a run across the edge at row 8
    yield "run-across-an-edge", edge
    whole = base.copy()
    whole[9:41] = whole[8, -1]  # rows 9-40: blocks of 8 rows at 16-39 are all run
    yield "run-spans-whole-blocks", whole
    last = base.copy()
    last[40:] = last[39, -1]  # the last block is all run, to the raster's end
    yield "last-block-all-run", last
    yield "all-run", np.full((24, 8, 3), 99, np.uint8)


@pytest.mark.parametrize("rows", [4, 5, 8, 48])
@pytest.mark.parametrize("name,img", list(_rasters()), ids=lambda x: x if isinstance(x, str) else "")
def test_blocked_reference_equals_the_whole_image_reference(name, img, rows):
    assert blocked.encode(img, rows=rows, procs=2) == codec.encode(img)


def test_blocked_reference_imports_nothing_of_the_program():
    code = ("import sys, numpy as np; from benchmark.reference import blocked; "
            "blocked.encode(np.zeros((8, 8, 3), np.uint8), rows=4, procs=1); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'nicetpu_torch', 'nicetpu', 'jax', 'jaxlib', 'torch'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=_tiny.REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_the_cell_runs_correct_at_a_tiny_size(tiny):
    r = run.run_cell(tiny, CELL, SEED, 600.0, False, device="cpu", max_calls=2)
    assert r["correct"], r["checks"]
    assert r["checks"]["images_checked"]["value"] == 2 and r["failed"] == 0
    assert set(r["metrics"]) == {"raw_MBps", "setup_s"}


def test_a_traced_run_reads_the_group_metrics(tiny):
    r = run.run_cell(tiny, CELL, SEED + 1, 0.1, True, device="cpu")
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    # no device on the CPU: the roofline and the idle share read nothing,
    # no card has a peak; the stage times are the host's, whose gloo
    # collectives block
    assert set(got) == {"dist.collective_ms", "dist.stitch_ms", "dist.carry_ms", "dist.fallback_pct",
                        "dist.assembly_ms", "dist.peak_card_GiB"}
    assert got["dist.fallback_pct"] == 0.0 and got["dist.peak_card_GiB"] == 0.0
    assert got["dist.collective_ms"] > 0 and got["dist.carry_ms"] > 0 and got["dist.stitch_ms"] > 0
    assert got["dist.assembly_ms"] > 0


def _flip_a_byte(answer):
    data, verified, decoded = answer
    return data[:-6] + bytes([data[-6] ^ 1]) + data[-5:], verified, decoded


def _wrong_pixel_on_rank_1(answer):
    """A claimed proof over a raster with one pixel wrong in rank 1's rows."""
    data, verified, decoded = answer
    if decoded is None:
        return answer
    decoded = decoded.copy()
    decoded[decoded.shape[0] // 4 + 1, 3, 0] ^= 1
    return data, True, decoded


def _unproven_wrong_pixel(answer):
    """The right bytes, no proof, and one pixel wrong in rank 1's rows: a
    device decode that went wrong where the bytes did not."""
    data, verified, decoded = answer
    if decoded is None:
        return answer
    decoded = decoded.copy()
    decoded[decoded.shape[0] // 4 + 1, 3, 0] ^= 1
    return data, False, decoded


class Faulty:
    def __init__(self, program, fault):
        self.program, self.fault = program, fault

    def watch(self, items):
        self.program.watch(items)

    def call(self, batch, stats):
        return [self.fault(a) for a in self.program.call(batch, stats)]

    def traced(self, batch, stats, marks):
        return [self.fault(a) for a in self.program.traced(batch, stats, marks)]


@pytest.mark.parametrize("fault", [_flip_a_byte, _wrong_pixel_on_rank_1, _unproven_wrong_pixel],
                         ids=lambda f: f.__name__)
def test_planted_faults_are_not_correct(tiny, fault):
    r = run.run_cell(tiny, CELL, SEED, 0.1, False, device="cpu",
                     make_program=lambda call, pool, inputs, dev: Faulty(call.Program(dev, pool), fault))
    assert not r["correct"]
    assert r["checks"]["images_wrong"]["value"] >= 1


def test_control_is_not_correct(tiny):
    r = control.run(tiny, CELL, SEED, 4, "cpu")
    assert not r["correct"]
    assert r["checks"]["images_wrong"]["value"] == r["checks"]["images_checked"]["value"] > 0
