"""The port's spans (`nicetpu_torch.utils.profiling.span`), its stage marks
and the round trip's counter and planes hook, on the CPU.

Off, a span records nothing and makes no CUDA event; with a `marks` list it
marks its stage's end as `mark_stage` does, and the marks of the traced
entries keep the names and order they had before the spans (pinned below).
On, under `torch.profiler` or `profiling.recording()`, each span is an
ordinary host range named "nt:<layer>.<stage>" in the trace and a record in
a bounded store with its parent, its call and its self time.
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nicetpu_torch import api, pipeline
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import decode3, encode2
from nicetpu_torch.kernels.geometry import Geometry
from nicetpu_torch.utils import profiling

CPU = torch.device("cpu")
H, W = 16, 24

# the marks of the traced entries before they had spans, in order, on `_smooth(noise=False)`
ENCODE_MARKS = ["start", "upload", "tokenize+histogram", "counts_to_host", "host_tables",
                "tables_to_device", "join", "fold", "place", "fetch+assembly"]
CORE_MARKS = ["walk_round1", "walk_round2", "assemble", "value_join", "records+place", "recon"]
ROUNDTRIP_MARKS = (["tokenize", "histogram", "huffman_build", "join", "fold", "place", "tables"]
                   + CORE_MARKS + ["equality", "robust_retry", "fetch+assembly"])


def _smooth(n=2, noise=True):
    """Smooth images; with a little noise they verify on the fast rung,
    without it on the robust one."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for b in range(n):
        base = (120 + 40 * np.sin(xx / 9.0 + b) + 30 * np.cos(yy / 5.0)).astype(np.int32)
        img = np.stack([base, base + 7, base - 9], axis=-1) + noise * rng.integers(-2, 3, (H, W, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _long_run():
    """A run of 767 pixels: 4 base-8 digits, past the fused encode's 3."""
    img = np.zeros((H * 2, W, 3), np.uint8)
    img[0, 0] = 7
    return img


class _Events:
    """Stands in for `torch.cuda.Event` on the CPU and counts the events."""

    made = 0

    def __init__(self, **kwargs):
        type(self).made += 1

    def record(self):
        pass


@pytest.fixture
def events(monkeypatch):
    _Events.made = 0
    monkeypatch.setattr(profiling.torch.cuda, "Event", _Events)
    return _Events


def _names(marks):
    return [n for n, _ in marks]


def test_off_span_records_nothing_and_makes_no_event(events):
    assert not torch.autograd._profiler_enabled()
    t0 = time.perf_counter()
    a, b = profiling.span("x.a"), profiling.span("x.b")
    assert a is b  # one shared null context
    with a:
        with b:
            pass
    assert events.made == 0 and profiling.spans(t0).spans == []
    marks = []
    with profiling.span("x.stage", marks):
        pass
    assert _names(marks) == ["stage"] and events.made == 1
    assert profiling.spans(t0).spans == []
    with pytest.raises(ValueError):
        with profiling.span("x.failed", marks):
            raise ValueError("no mark for a stage that raised")
    assert _names(marks) == ["stage"]


@pytest.mark.parametrize("on", [False, True], ids=["spans_off", "spans_on"])
def test_marks_keep_their_names_and_order(events, on):
    imgs = _smooth(noise=False)
    datas = [oracle.encode_native(im) for im in imgs]
    args, _ = decode3.prepare_batch_args(datas, device=CPU)
    cfg = decode3.LADDER[0]
    got = {}
    with profiling.recording() if on else contextlib.nullcontext():
        got["encode"] = []
        encode2.encode_batch(np.stack(imgs), device=CPU, marks=got["encode"])
        got["roundtrip"] = []
        pipeline.roundtrip_batch_resident(pipeline.upload_batch(imgs, CPU), imgs, marks=got["roundtrip"])
        got["core"] = []
        decode3._decode_core_v3(*args, geom=Geometry.uniform(W, H * W, len(imgs), CPU), chunk_bits=cfg.chunk_bits,
                                steps=decode3._steps(cfg.chunk_bits, cfg.steps_div), rounds=cfg.rounds,
                                marks=got["core"])
    assert _names(got["encode"]) == ENCODE_MARKS
    assert _names(got["roundtrip"]) == ROUNDTRIP_MARKS
    assert _names(got["core"]) == CORE_MARKS
    assert encode2.mark_stage is profiling.mark_stage


def test_profiler_ranges_parents_calls_and_self_time():
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("t.outer"):
            time.sleep(0.004)
            with profiling.span("t.inner"):
                time.sleep(0.01)
            with profiling.span("t.inner"):
                with profiling.span("t.leaf"):
                    time.sleep(0.003)
        with profiling.span("t.second"):
            pass
    ranges = {e.name: e for e in prof.events() if e.name.startswith(profiling.PREFIX)}
    assert set(ranges) == {"nt:t.outer", "nt:t.inner", "nt:t.leaf", "nt:t.second"}
    assert not any(e.is_user_annotation for e in ranges.values())
    got = profiling.spans(t0)
    assert [s.name for s in got.spans] == ["t.outer", "t.inner", "t.inner", "t.leaf", "t.second"]
    outer, in1, in2, leaf, second = got.spans
    assert outer.parent is None and second.parent is None
    assert in1.parent == in2.parent == outer.id and leaf.parent == in2.id
    assert outer.call == in1.call == in2.call == leaf.call != second.call
    dur = {s.id: 1e3 * (s.end - s.start) for s in got.spans}
    assert outer.self_ms == pytest.approx(dur[outer.id] - dur[in1.id] - dur[in2.id])
    assert in2.self_ms == pytest.approx(dur[in2.id] - dur[leaf.id])
    assert leaf.self_ms == pytest.approx(dur[leaf.id]) and 3.0 <= outer.self_ms
    assert got.total_ms["t.inner"] == pytest.approx(dur[in1.id] + dur[in2.id])
    assert not torch.autograd._profiler_enabled() and profiling.span("t.x") is profiling.span("t.y")


def test_threads_keep_separate_stacks():
    t0 = time.perf_counter()
    ready = threading.Barrier(2, timeout=10)

    def work(name):
        with profiling.span(f"{name}.outer"):
            ready.wait()  # both outer spans are open at once
            with profiling.span(f"{name}.inner"):
                ready.wait()

    with profiling.recording():
        threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in profiling.spans(t0).spans}
    assert set(got) == {"a.outer", "a.inner", "b.outer", "b.inner"}
    for n in ("a", "b"):
        assert got[f"{n}.outer"].parent is None
        assert got[f"{n}.inner"].parent == got[f"{n}.outer"].id
        assert got[f"{n}.inner"].call == got[f"{n}.outer"].call
        assert got[f"{n}.inner"].thread == got[f"{n}.outer"].thread
    assert got["a.outer"].call != got["b.outer"].call


def test_store_keeps_at_most_its_bound():
    t0 = time.perf_counter()
    with profiling.recording():
        for _ in range(profiling.MAX_SPANS + 100):
            with profiling.span("bound.s"):
                pass
    got = profiling.spans(t0)
    assert len(profiling._store) == profiling.MAX_SPANS == len(got.spans)
    assert got.spans[-1].id - got.spans[0].id == profiling.MAX_SPANS - 1


def test_recording_without_a_profiler_and_nested():
    t0 = time.perf_counter()
    with profiling.recording():
        with profiling.recording():
            with profiling.span("rec.a"):
                pass
        with profiling.span("rec.b"):
            pass
    with profiling.span("rec.c"):
        pass
    assert [s.name for s in profiling.spans(t0).spans] == ["rec.a", "rec.b"]
    assert profiling._recording == 0


@pytest.mark.parametrize("entry,names", [
    ("decode_batch", {"decode3.device_groups", "decode3.batch_args", "decode3.rung", "decode3.sync",
                      "decode3.fetch", "decode3.ladder_merge", "decode3.to_arrays",
                      "decode3.walk_round1", "decode3.recon"}),
    ("encode_batch", {"encode2.encode_batch", "encode2.encode_resident", "encode2.build_tables_host",
                      "encode2.assemble", "encode2.fetch", "encode2.bytes"}),
    ("roundtrip_batch", {"pipeline.upload_batch", "pipeline.roundtrip_batch_resident",
                         "decode3.roundtrip_verify_fused", "decode3.equality", "pipeline.assemble_payloads",
                         "pipeline.fetch", "pipeline.bytes"}),
])
def test_api_calls_are_one_call_of_named_spans(entry, names):
    imgs = _smooth()
    args = [oracle.encode_native(im) for im in imgs] if entry == "decode_batch" else imgs
    t0 = time.perf_counter()
    with profiling.recording():
        getattr(api, entry)(args, device=CPU)
    got = profiling.spans(t0)
    roots = [s for s in got.spans if s.parent is None]
    assert [s.name for s in roots] == [f"api.{entry}"]
    assert names <= set(got.total_ms)
    assert all(s.call == roots[0].call for s in got.spans)


def test_overflow_decoded_counts_the_device_decodes_of_overflowed_images():
    img = _long_run()
    stats = {}
    for _ in range(2):
        datas, verified = pipeline.roundtrip_batch_resident(pipeline.upload_batch([img], CPU), [img],
                                                            stats=stats)
        assert datas == [oracle.encode_native(img)] and verified.tolist() == [False]
    assert stats == {"overflow_fallbacks": 2, "retries": 0, "fallbacks": 0, "overflow_decoded": 2}


def test_equal_planar_sees_every_rung_that_verifies(monkeypatch):
    """The benchmark's round-trip check wraps `decode3._equal_planar`: the
    fused rung and each rung of `verify_words_device` hand it their decoded
    (B, 3, N) planes."""
    seen = []
    real = decode3._equal_planar

    def wrapper(out, flat):
        seen.append(tuple(out.shape))
        return real(out, flat)

    monkeypatch.setattr(decode3, "_equal_planar", wrapper)
    imgs = _smooth(3)
    flat = pipeline.upload_batch(imgs, CPU)
    geom = Geometry.uniform(W, H * W, 3, CPU)
    words, small, _ = decode3.roundtrip_verify_fused(flat, geom=geom)
    assert seen == [(3, 3, H * W)]
    seen.clear()
    short = decode3.WalkCfg(2048, 32, 64, 1)  # 32 steps: no chunk crosses its end
    verified = decode3.verify_words_device(words, small[:, 858], small[:, :858], flat, geom=geom,
                                           ladder=(short, decode3.LADDER[0]))
    assert seen == [(3, 3, H * W)] * 2 and verified.all()
