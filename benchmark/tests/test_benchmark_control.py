"""The check's control and planted faults, at a tiny size on the CPU: each
has to come out not correct, where the program as it is comes out correct.
On the card, one short run of each cell has to come out correct."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _tiny
from benchmark import control, run
from benchmark.spec import Spec

SEED = 2**31 + 23
CELLS = ["kodak24-decode", "kodak24-encode", "kodak24-roundtrip", "raster4096-roundtrip"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = _tiny.make(str(tmp_path_factory.mktemp("tiny")))
    return Spec(root, os.path.join(root, "benchmark"))


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    r = control.run(tiny, cell, SEED, 12, "cpu")
    assert not r["correct"]
    assert r["checks"]["images_wrong"]["value"] == r["checks"]["images_checked"]["value"] > 0


def _alter(out):
    """The first answer altered where it is produced: one byte changed."""
    first = out[0]
    if isinstance(first, np.ndarray):
        first = first.copy()
        first[0, 0, 0] ^= 1
    elif isinstance(first, tuple):
        first = (first[0][:-1] + bytes([first[0][-1] ^ 1]),) + first[1:]
    else:
        first = first[:-1] + bytes([first[-1] ^ 1])
    return [first] + list(out[1:])


def _half(out):
    """Half of the batch left out."""
    return list(out[: len(out) // 2])


class Faulty:
    def __init__(self, program, fault):
        self.program, self.fault = program, fault

    def call(self, batch, stats):
        return self.fault(self.program.call(batch, stats))

    def traced(self, batch, stats, marks):
        return self.fault(self.program.traced(batch, stats, marks))

    def __getattr__(self, name):  # watch, resident_bytes
        return getattr(self.program, name)


@pytest.mark.parametrize("fault", [_alter, _half], ids=["answer_altered", "half_batch"])
@pytest.mark.parametrize("cell", ["kodak24-decode", "kodak24-encode", "kodak24-roundtrip"])
def test_planted_fault_is_not_correct(tiny, cell, fault):
    r = run.run_cell(tiny, cell, SEED, 0.1, False, device="cpu",
                     make_program=lambda c, p, i, d: Faulty(c.Program(d, p), fault))
    assert not r["correct"] and r["checks"]["images_wrong"]["value"] > 0


def _patched_round_trip(tiny, monkeypatch, bypass: bool) -> dict:
    """A round trip whose device decode gives wrong pixels while it says
    the device verified every image: with its compare going through the
    watched function, or (bypass) around it."""
    from nicetpu_torch.kernels import decode3

    core, verify = decode3._decode_core_v3, decode3.roundtrip_verify_fused

    def wrong_planes(*args, **kwargs):
        out, ok, rest = core(*args, **kwargs)
        return out ^ 1, ok, rest

    def claims_verified(*args, **kwargs):
        words, small, verified = verify(*args, **kwargs)
        return words, small, np.ones_like(verified)

    def make(c, p, i, d):
        program = c.Program(d, p)  # wraps the program's compare
        monkeypatch.setattr(decode3, "_decode_core_v3", wrong_planes)
        monkeypatch.setattr(decode3, "_raise_if_consistent_but_wrong", lambda ok, eq: None)
        monkeypatch.setattr(decode3, "roundtrip_verify_fused", claims_verified)
        if bypass:
            monkeypatch.setattr(decode3, "_equal_planar", lambda out, flat: torch.ones(out.shape[0], dtype=torch.bool))
        return program

    return run.run_cell(tiny, "kodak24-roundtrip", SEED, 0.1, False, device="cpu", make_program=make)


@pytest.mark.parametrize("bypass", [False, True], ids=["planes_wrong", "compare_bypassed"])
def test_round_trip_verified_over_wrong_device_pixels_is_not_correct(tiny, monkeypatch, bypass):
    r = _patched_round_trip(tiny, monkeypatch, bypass)
    # the bytes are the encoder's and right; only the device's claim is wrong
    assert not r["correct"] and r["failed"] == 0
    assert r["checks"]["images_wrong"]["value"] == r["checks"]["images_checked"]["value"] > 0


def test_failed_call_is_not_correct(tiny):
    calls = []

    def boom(out):  # the warm-up call passes, every window call raises
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return out

    r = run.run_cell(tiny, "kodak24-encode", SEED, 0.1, False, device="cpu",
                     make_program=lambda c, p, i, d: Faulty(c.Program(d, p), boom))
    assert not r["correct"] and r["failed"] == r["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", str(SEED),
                        "--seconds", "2", "--trace", "0"], cwd=_tiny.REPO, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    import json

    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
