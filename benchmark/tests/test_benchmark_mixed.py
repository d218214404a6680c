"""The cell `mixed100-roundtrip` on the CPU, with a tiny copy of its
configuration: the content kind's shapes, a correct run, the batching
metrics of a traced run, planted faults and the control."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import _tiny
from benchmark import control, corpus, run
from benchmark.calls import roundtrip_mixed
from benchmark.content import mixed_patches
from benchmark.spec import Spec

REPO = _tiny.REPO
SEED = 2**31 + 25
CELL = "mixed100-roundtrip"
SHAPES = [[9, 12], [16, 8], [8, 21], [5, 17], [12, 6], [7, 9], [8, 8], [4, 22], [10, 13]]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = _tiny.make(str(tmp_path_factory.mktemp("tiny")))
    path = os.path.join(root, "benchmark", "configs", "mixed100.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(shapes=SHAPES, pool=2 * len(SHAPES), per_call=len(SHAPES), warmup_calls=1, trace_calls=1)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return Spec(root, os.path.join(root, "benchmark"))


@pytest.fixture(scope="module")
def pixels():
    return corpus.load(REPO, ["wood", "marble", "skin"])


def _sets(pool, n):
    return [sorted(im.shape[:2] for im in pool[s : s + n]) for s in range(0, len(pool), n)]


def test_the_shapes_are_the_stated_draw():
    cfg = Spec(REPO).config("mixed100")
    rng = np.random.default_rng(9)
    assert cfg["shapes"] == [[int(rng.integers(128, 768)), int(rng.integers(128, 768))] for _ in range(100)]
    assert len({tuple(s) for s in cfg["shapes"]}) == 100 and cfg["pool"] == 2 * cfg["per_call"] == 200


def test_content_gives_the_configured_shapes_from_the_seed(tiny, pixels):
    for cfg in (tiny.config("mixed100"), Spec(REPO).config("mixed100")):
        a, b = mixed_patches.make(cfg, SEED, pixels), mixed_patches.make(cfg, SEED, pixels)
        c = mixed_patches.make(cfg, SEED + 1, pixels)
        want = sorted(tuple(s) for s in cfg["shapes"])
        assert _sets(a, len(want)) == _sets(c, len(want)) == [want, want]
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert not all(np.array_equal(x, y) for x, y in zip(a, c))
        # the two sets are cut afresh
        first = {im.shape[:2]: im for im in a[: len(want)]}
        assert not all(np.array_equal(first[im.shape[:2]], im) for im in a[len(want):])


def test_cell_runs_correct_at_a_tiny_size(tiny):
    r = run.run_cell(tiny, CELL, SEED, 0.1, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["checks"]["images_checked"]["value"] >= len(SHAPES) and r["failed"] == 0
    assert set(r["metrics"]) == {"raw_MBps", "setup_s"}


def test_traced_run_reads_the_batching_metrics(tiny):
    r = run.run_cell(tiny, CELL, SEED, 0.1, True, device="cpu")
    assert r["correct"], r["checks"]
    n = sorted((h * w for h, w in SHAPES), reverse=True)
    held = 8 * n[0] + n[8]  # batches of 8 and of 1, largest first
    assert r["metrics"]["api.images_per_batch"]["value"] == pytest.approx(len(SHAPES) / 2)
    assert r["metrics"]["pipeline.pad_pct"]["value"] == pytest.approx(100 * (held - sum(n)) / sum(n))
    assert r["metrics"]["decode3.fallback_pct"]["value"] == 0


@pytest.mark.parametrize("api_marks", [True, False], ids=["api_takes_marks", "api_without_marks"])
def test_traced_hands_the_marks_to_every_batch(tiny, pixels, monkeypatch, api_marks):
    """The traced call's marks reach each batch's round trip, through
    `api.roundtrip_batch(marks=)` or, where the program's entry takes no
    marks (one-image batches, as a shape-keyed planner runs this set),
    through each `pipeline.roundtrip_batch_resident` call."""
    import torch

    from nicetpu_torch import api, pipeline

    seen, resident = [], pipeline.roundtrip_batch_resident

    def spy(*args, marks=None, **kwargs):  # the CPU records no CUDA events: the list is only handed on
        seen.append(marks)
        return resident(*args, **kwargs)

    def without_marks(imgs, *, device="cuda", stats=None):
        out = [pipeline.roundtrip_batch_resident(pipeline.upload_batch([im], device), [im], stats=stats)
               for im in imgs]
        return [datas[0] for datas, _ in out], np.array([ok[0] for _, ok in out])

    monkeypatch.setattr(pipeline, "roundtrip_batch_resident", spy)
    if not api_marks:
        monkeypatch.setattr(api, "roundtrip_batch", without_marks)
    pool = mixed_patches.make(tiny.config("mixed100"), SEED, pixels)
    program = roundtrip_mixed.Program(torch.device("cpu"), pool)
    marks: list = []
    out = program.traced(pool[: len(SHAPES)], {}, marks)
    assert len(out) == len(SHAPES) and all(a[1] for a in out)
    assert len(seen) == (2 if api_marks else len(SHAPES)) and all(m is marks for m in seen)
    assert pipeline.roundtrip_batch_resident is spy


def _alter(out):
    """One byte of the first answer's bytes flipped."""
    first = out[0]
    return [(first[0][:-1] + bytes([first[0][-1] ^ 1]),) + first[1:]] + list(out[1:])


class Faulty:
    def __init__(self, program, fault):
        self.program, self.fault = program, fault

    def call(self, batch, stats):
        return self.fault(self.program.call(batch, stats))

    def traced(self, batch, stats, marks):
        return self.fault(self.program.traced(batch, stats, marks))

    def __getattr__(self, name):  # watch, resident_bytes
        return getattr(self.program, name)


def test_a_flipped_byte_is_not_correct(tiny):
    r = run.run_cell(tiny, CELL, SEED, 0.1, False, device="cpu",
                     make_program=lambda c, p, i, d: Faulty(c.Program(d, p), _alter))
    assert not r["correct"] and r["checks"]["images_wrong"]["value"] > 0


def test_swapped_planes_claimed_verified_are_not_correct(tiny, monkeypatch):
    """The device's planes of two images of a batch swapped, each a right
    decode of the other image, while the program says both verified."""
    from nicetpu_torch.kernels import decode3

    core, verify = decode3._decode_core_v3, decode3.roundtrip_verify_fused

    def swapped(*args, **kwargs):
        out, ok, gates = core(*args, **kwargs)
        order = [1, 0] + list(range(2, out.shape[0])) if out.shape[0] > 1 else [0]
        return out[order], ok, gates

    def claims_verified(*args, **kwargs):
        words, small, verified = verify(*args, **kwargs)
        return words, small, np.ones_like(verified)

    def make(c, p, i, d):
        program = c.Program(d, p)
        monkeypatch.setattr(decode3, "_decode_core_v3", swapped)
        monkeypatch.setattr(decode3, "_raise_if_consistent_but_wrong", lambda ok, eq: None)
        monkeypatch.setattr(decode3, "roundtrip_verify_fused", claims_verified)
        return program

    r = run.run_cell(tiny, CELL, SEED, 0.1, False, device="cpu", make_program=make)
    assert not r["correct"] and r["failed"] == 0
    assert r["checks"]["images_wrong"]["value"] > 0


def test_rows_are_matched_through_the_upload(tiny, pixels):
    """A row counts for the image its upload held, wherever it lies."""
    import torch

    pool = mixed_patches.make(tiny.config("mixed100"), SEED, pixels)[:3]
    program = roundtrip_mixed.Program(torch.device("cpu"), pool)
    n = max(im.shape[0] * im.shape[1] for im in pool)
    flat = torch.zeros(3, n, 3, dtype=torch.uint8)
    for b, im in enumerate(pool[::-1]):  # the upload holds the images in reverse
        flat[b, : im.shape[0] * im.shape[1]] = torch.from_numpy(im.reshape(-1, 3))
    program.watch([0, 1, 2])
    program.capture(flat.transpose(1, 2).clone(), flat)
    assert [a[2] for a in program.answers([b"x"] * 3, [True] * 3)] == [True, True, True]
    program.watch([0, 1, 2])
    program.capture(flat.transpose(1, 2)[[1, 0, 2]].clone(), flat)  # rows 0 and 1 swapped
    assert [a[2] for a in program.answers([b"x"] * 3, [True] * 3)] == [True, False, False]
    program.watch(None)


def test_control_is_not_correct(tiny):
    r = control.run(tiny, CELL, SEED, 3, "cpu")
    assert not r["correct"]
    assert r["checks"]["images_wrong"]["value"] == r["checks"]["images_checked"]["value"] > 0
