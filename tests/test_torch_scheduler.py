"""The schedulers of nicetpu_torch.pipeline on the CPU (device="cpu": the
kernels' plain versions), against the JAX package and the spec codec.

`roundtrip_hybrid` and `Pipeline` are held to the two cases of
tests/test_batch.py::TestHybridScheduler on the same seeded images: every
blob equals `nicetpu.spec.codec.encode` (and, for one case, what
`nicetpu.pipeline.roundtrip_hybrid` returns), every decoded array equals
its image.  Bytes and integers: every comparison is exact.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nicetpu.pipeline as jpipeline
from nicetpu.kernels import encode2 as jenc
from nicetpu.spec import codec
import nicetpu_torch
from nicetpu_torch import convert, pipeline
from nicetpu_torch.config import RuntimeConfig
from nicetpu_torch.kernels import cuda_ops

from test_torch_encode import _batch as _encode_batch, _long_run_image

CPU = torch.device("cpu")


def _hybrid_images():
    """The 12 images of TestHybridScheduler.test_hybrid_byte_exact_and_complete."""
    rng = np.random.default_rng(3)
    return [
        (rng.integers(0, 5, (16, 32, 1)) * 50 + rng.integers(0, 4, (16, 32, 3))).astype(np.uint8)
        for _ in range(12)
    ]


def _check_results(res, host_batches):
    assert len(res) == len(host_batches)
    for out, b in zip(res, host_batches):
        assert len(out) == len(b)
        for (d, dec), im in zip(out, b):
            assert d == codec.encode(im)
            np.testing.assert_array_equal(dec, im)


def test_hybrid_byte_exact_and_complete_and_equal_to_jax():
    imgs = _hybrid_images()
    hb = [imgs[i : i + 4] for i in range(0, 12, 4)]
    batches = [(b, pipeline.upload_batch(b, CPU)) for b in hb]
    res, stats = pipeline.roundtrip_hybrid(batches, gpu_threads=2, cpu_threads=1)
    assert stats["gpu_batches"] + stats["cpu_batches"] == len(batches)
    assert stats["fallbacks"] == 0 and stats["overflow_fallbacks"] == 0
    _check_results(res, hb)
    jres, jstats = jpipeline.roundtrip_hybrid(
        [(b, jpipeline.upload_batch(b)) for b in hb], tpu_threads=2, cpu_threads=1
    )
    assert jstats["tpu_batches"] + jstats["cpu_batches"] == len(batches)
    for out, jout in zip(res, jres):
        assert [d for d, _ in out] == [d for d, _ in jout]
        for (_, a), (_, ja) in zip(out, jout):
            np.testing.assert_array_equal(a, ja)


def test_hybrid_host_only_entries():
    """Entries without a device batch go to the host, also when a device
    worker pops them."""
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (8, 16, 3)).astype(np.uint8) for _ in range(4)]
    hb = [imgs[:2], imgs[2:]]
    res, stats = pipeline.roundtrip_hybrid([(b, None) for b in hb], gpu_threads=1, cpu_threads=0)
    assert stats["cpu_batches"] == 2 and stats["gpu_batches"] == 0
    _check_results(res, hb)


@pytest.mark.parametrize("gpu_threads,cpu_threads,key", [(2, 0, "gpu_batches"), (0, 2, "cpu_batches")],
                         ids=["device_workers_only", "host_workers_only"])
def test_hybrid_one_kind_of_worker_takes_every_batch(gpu_threads, cpu_threads, key):
    imgs = _hybrid_images()[:8]
    hb = [imgs[i : i + 2] for i in range(0, 8, 2)]
    batches = [(b, pipeline.upload_batch(b, CPU)) for b in hb]
    stats = {"gpu_batches": 0, "cpu_batches": 0}
    res, out_stats = pipeline.roundtrip_hybrid(
        batches, gpu_threads=gpu_threads, cpu_threads=cpu_threads, stats=stats)
    assert out_stats is stats
    assert stats[key] == len(hb) and stats["gpu_batches"] + stats["cpu_batches"] == len(hb)
    _check_results(res, hb)


def test_hybrid_needs_a_worker():
    with pytest.raises(ValueError, match="at least one worker"):
        pipeline.roundtrip_hybrid([([_hybrid_images()[0]], None)], gpu_threads=0, cpu_threads=0)
    assert pipeline.roundtrip_hybrid([], gpu_threads=0, cpu_threads=0)[0] == []


def test_hybrid_counts_a_batch_the_device_verified_nothing_of_as_a_host_batch():
    """A batch whose only image overflows the fused encode (a 767-pixel
    run) is encoded and proven by the host: a cpu_batch, one overflow
    fallback, no gpu_batch."""
    img = _long_run_image()
    res, stats = pipeline.roundtrip_hybrid(
        [([img], pipeline.upload_batch([img], CPU))], gpu_threads=1, cpu_threads=0)
    assert (stats["gpu_batches"], stats["cpu_batches"]) == (0, 1)
    assert stats["overflow_fallbacks"] == 1 and stats["fallbacks"] == 0
    _check_results(res, [[img]])


@pytest.mark.parametrize("cpu_threads", [0, 1])
def test_injected_bug_in_the_device_leg_propagates(monkeypatch, cpu_threads):
    """An exception in a device worker is a defect: the call raises it, and
    the host does not quietly take the batch."""

    def boom(*a, **k):
        raise AssertionError("injected kernel bug")

    imgs = _hybrid_images()[:4]
    batches = [([im], pipeline.upload_batch([im], CPU)) for im in imgs]
    monkeypatch.setattr(pipeline, "roundtrip_batch_resident", boom)
    with pytest.raises(AssertionError, match="injected kernel bug"):
        pipeline.roundtrip_hybrid(batches, gpu_threads=1, cpu_threads=cpu_threads)
    monkeypatch.setattr(pipeline, "encode_fused", boom)
    with pytest.raises(AssertionError, match="injected kernel bug"):
        pipeline.encode_batch_fused(imgs[:1], device=CPU)


def _mixed_shapes():
    rng = np.random.default_rng(5)
    shapes = [(16, 32)] * 5 + [(8, 16)] * 2 + [(16, 32)] + [(12, 20)] * 3
    return [rng.integers(0, 40, (h, w, 3)).astype(np.uint8) for h, w in shapes]


def _pipe(batch, workers=2):
    return pipeline.Pipeline(config=RuntimeConfig(backend="cpu", batch_size=batch, workers=workers))


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_pipeline_chunks_equal_the_jax_pipeline_chunks(batch):
    imgs = _mixed_shapes()
    with _pipe(batch) as p, jpipeline.Pipeline(workers=1, batch=batch) as jp:
        got, want = p._chunks(imgs), jp._chunks(imgs)
    assert [[id(im) for im in c] for c in got] == [[id(im) for im in c] for c in want]


def test_pipeline_sizes_come_from_the_config():
    with pipeline.Pipeline(config=RuntimeConfig(backend="cpu")) as p:
        assert p.batch == nicetpu_torch.api.MAX_BATCH == 8 and p.device == CPU
        assert p.workers == p._pool._max_workers == RuntimeConfig().workers
    with pipeline.Pipeline(workers=1, batch=3, config=RuntimeConfig(backend="native")) as p:
        assert p.batch == 3 and p.device is None and p.workers == p._pool._max_workers == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline.Pipeline(config=RuntimeConfig())


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_pipeline_encode_many_and_roundtrip_many_are_exact(backend):
    imgs = _mixed_shapes() + [_long_run_image()]
    stats = {}
    with pipeline.Pipeline(config=RuntimeConfig(backend=backend, batch_size=4, workers=3)) as p:
        p.warmup(imgs)
        datas = p.encode_many(imgs, stats)
        pairs = p.roundtrip_many(imgs)
    assert datas == [codec.encode(im) for im in imgs]
    assert [d for d, _ in pairs] == datas
    for (_, a), im in zip(pairs, imgs):
        np.testing.assert_array_equal(a, im)
    assert stats == {"overflow_fallbacks": 1 if backend == "cpu" else 0}


def test_encode_one_and_its_checks():
    img = _hybrid_images()[0]
    assert pipeline.encode_one(img, device="cpu") == codec.encode(img)
    with pytest.raises(ValueError):
        pipeline.encode_one(img[:, :, 0], device="cpu")
    with pytest.raises(ValueError):
        pipeline.encode_one(img.astype(np.int32), device="cpu")


def test_encode_batch_resident_returns_the_words_and_small_of_jax_encode_fused():
    imgs = list(_encode_batch())
    B, (H, W, _) = len(imgs), imgs[0].shape
    flat = pipeline.upload_batch(imgs, CPU)
    datas, words_d, small = pipeline.encode_batch_resident(flat, imgs, return_device=True)
    assert datas == [codec.encode(im) for im in imgs]
    assert pipeline.encode_batch_resident(flat, imgs) == datas
    assert pipeline.w_cap(H * W) == jpipeline._w_cap(H * W)
    jw, js = jenc.encode_fused(jnp.asarray(flat.numpy()), width=W, ndigits_cap=3,
                               w_cap=jpipeline._w_cap(H * W))
    assert small.shape == (B, 860)
    np.testing.assert_array_equal(small, np.asarray(js))
    np.testing.assert_array_equal(convert.words_to_numpy(words_d), np.asarray(jw))


@pytest.fixture
def short_switch_interval():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def test_launch_counts_stay_exact_under_threads(short_switch_interval):
    """More threads than cores adding to one count: a lost update would
    leave it short."""
    cuda_ops.reset_launches()
    threads = [threading.Thread(target=lambda: [cuda_ops.count_launch("walk") for _ in range(2000)])
               for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert cuda_ops.LAUNCHES["walk"] == 16 * 2000
    cuda_ops.reset_launches()
    assert cuda_ops.LAUNCHES["walk"] == 0


def test_hybrid_queue_hands_out_every_batch_once(short_switch_interval):
    """Many workers on both ends of a queue of tiny host entries: every
    entry is taken exactly once and the counts add up."""
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 9, (4, 8, 3)).astype(np.uint8) for _ in range(48)]
    res, stats = pipeline.roundtrip_hybrid([([im], None) for im in imgs], gpu_threads=8, cpu_threads=8)
    assert stats["cpu_batches"] == 48 and stats["gpu_batches"] == 0
    _check_results(res, [[im] for im in imgs])
