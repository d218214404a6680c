"""The port's sharded codec (`nicetpu_torch.dist`) over gloo ranks on the
CPU, held against JAX's `dist` on `make_mesh(4)`, against `hostref` and
against the images.  The ranks are spawned processes
(`nicetpu_torch.dist.launch.run`), each call under its own time limit, so a
hang fails the test instead of running the suite out; every single-raster
and batch case runs inside one spawn of four ranks."""

import ast
import os

import numpy as np
import pytest
import torch

from nicetpu.dist import sharded_decode as jsd
from nicetpu.dist.sharded import encode_sharded as jax_encode_sharded
from nicetpu.dist.sharded import make_mesh
from nicetpu.hostref import oracle
from nicetpu.kernels import decode3 as jd3
import nicetpu_torch
from nicetpu_torch import bench_all
from nicetpu_torch.dist import launch
from nicetpu_torch.dist.multihost import initialize_distributed
from nicetpu_torch.kernels.decode3 import WalkCfg, payload_bits
from nicetpu_torch.utils import profiling

import _torch_dist_worker as worker

N_DEV = 4
TIMEOUT = 240.0  # seconds a spawn may take before every rank is killed


def _cases():
    """The four rasters of tests/test_kernels.py::TestSharded."""
    rng = np.random.default_rng(13)
    noise = rng.integers(0, 256, (32, 16, 3), dtype=np.uint8)
    few = (rng.integers(0, 4, (64, 8, 1)) * 60 + rng.integers(0, 4, (64, 8, 3))).astype(np.uint8)
    cross = rng.integers(0, 256, (40, 12, 3), dtype=np.uint8)
    cross[13:27] = cross[12, -1]  # a run across shard boundaries
    flat = np.full((48, 8, 3), 77, dtype=np.uint8)  # a whole-image run
    return {"noise": noise, "few-level": few, "run-across-shards": cross, "whole-image-run": flat}


def _mkimg(h, w, seed=0):
    """tests/test_sharded_decode.py's image."""
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 5, (h, w, 1)) * 50 + rng.integers(0, 4, (h, w, 3))).astype(np.uint8)
    img[h // 3] = img[h // 3, 0]
    return img


CASES = _cases()
NOISY = np.random.default_rng(3).integers(0, 256, (64, 64, 3)).astype(np.uint8)
BATCH = [_mkimg(32, 64, s) for s in range(8)]
TALL = _mkimg(30, 64, 5)  # 30 rows: no split into 4 blocks
# the JAX decode_sharded defaults: CHUNK_BITS, STEPS_DIV, 3 rounds
JAX_CFG = WalkCfg(jd3.CHUNK_BITS, jd3._rows_for(jd3.CHUNK_BITS), jd3.STEPS_DIV, 3)
TIGHT_CFG = WalkCfg(4096, 8, 512, 3)  # 8 steps a 4096-bit chunk: no chunk crosses
CONFIG5_SIDE = 64  # the bench's config 5 on a small raster
# the spans "dist.<stage>" of a rank, in order
ENCODE_STAGES = ("upload", "halo", "first_changes", "tokenize", "histogram_psum", "tables", "pack",
                 "gather_words", "stitch")
DECODE_STAGES = ("decode_tables", "walk", "assembly", "records_all_gather", "place", "carry_wait",
                 "recon")
DECODED = list(CASES.values()) + [NOISY]


@pytest.fixture(scope="module")
def port():
    blobs = [oracle.encode_native(im) for im in DECODED]
    return launch.run(
        worker.sharded_cases, N_DEV, backend="gloo", device="cpu", timeout=TIMEOUT,
        args=(list(CASES.values()), blobs, JAX_CFG, [oracle.encode_native(im) for im in BATCH],
              oracle.encode_native(TALL), TIGHT_CFG, CONFIG5_SIDE),
    )


@pytest.mark.parametrize("i,name", list(enumerate(CASES)))
def test_encode_equals_jax_and_hostref(port, i, name):
    img = CASES[name]
    want = oracle.encode_native(img)
    assert jax_encode_sharded(img, make_mesh(N_DEV)) == want
    for rank in port:
        data, st = rank["encode"][i]
        assert data == want
        assert st["overflow_fallbacks"] == 0
        assert set(st["stages"]) == set(ENCODE_STAGES) | {"bytes_broadcast"}


@pytest.mark.parametrize("i", range(len(DECODED)))
def test_decode_equals_the_image(port, i):
    for rank in port:
        out, st = rank["decode"][i]
        np.testing.assert_array_equal(out, DECODED[i])
        assert st["fallbacks"] == 0
        assert st["gates"] == dict.fromkeys(("consistency", "crossing", "coverage", "backref"), True)
        assert set(st["stages"]) == set(DECODE_STAGES) | {"gather_decoded"}


def test_noisy_decode_equals_jax(port):
    want = jsd.decode_sharded(oracle.encode_native(NOISY), make_mesh(N_DEV))
    np.testing.assert_array_equal(port[0]["decode"][len(CASES)][0], want)


def test_batch_decode_equals_jax_and_the_images(port):
    want = jsd.decode_batch_sharded([oracle.encode_native(im) for im in BATCH], make_mesh(N_DEV))
    for rank in port:
        outs, st = rank["batch"]
        assert len(outs) == len(BATCH)
        for out, w, im in zip(outs, want, BATCH):
            np.testing.assert_array_equal(out, w)
            np.testing.assert_array_equal(out, im)
        assert st == {"retries": 0, "fallbacks": 0}


def test_unshardable_height_is_a_counted_fallback(port):
    for rank in port:
        out, st = rank["tall"]
        np.testing.assert_array_equal(out, TALL)
        assert st["fallbacks"] == 1


def test_failed_gates_are_a_counted_fallback(port):
    """A step budget no chunk can cross with: later shards are entered
    before their slice, the gates reject the raster, the host decodes it."""
    for rank in port:
        out, st = rank["tight"]
        np.testing.assert_array_equal(out, DECODED[0])
        assert st["fallbacks"] == 1 and st["gates"]["crossing"] is False


def test_a_shard_past_the_walks_limit_is_a_counted_fallback(port):
    """A shard of more than decode3.MAX_DEVICE_BITS bits (the limit lowered
    on every rank) is decoded by the host, exact."""
    for rank in port:
        out, st = rank["over_limit"]
        np.testing.assert_array_equal(out, DECODED[0])
        assert st["fallbacks"] == 1 and "walk" not in st.get("stages", {})


def test_bench_config5_rank_function(port):
    """Each rank of the bench's config 5: bytes equal hostref's (by digest),
    the raster exact, no fallback, and the fields that the config's line
    reports (the kernels' launch counts are checked on the card)."""
    ref = oracle.encode_native(bench_all.make_img(CONFIG5_SIDE, CONFIG5_SIDE, bench_all.CONFIG5_SEED))
    res = [rank["config5"] for rank in port]
    bench_all.config5_check(res, ref, on_card=False)
    assert [r["rank"] for r in res] == list(range(N_DEV))
    for r in res:
        assert r["payload_bits"] == payload_bits(ref)
        assert r["encode_s"] > 0 and r["decode_s"] > 0 and r["peak_rss_gib"] > 0
        assert r["encode_peak_device_gib"] is None and r["decode_peak_device_gib"] is None
        assert set(DECODE_STAGES) <= set(r["decode_stats"]["stages"])
        assert set(ENCODE_STAGES) <= set(r["encode_stats"]["stages"])


def test_an_overflow_on_one_rank_sends_the_raster_to_the_host(port):
    want = oracle.encode_native(DECODED[0])
    for rank in port:
        data, st = rank["overflow"]
        assert data == want
        assert st["overflow_fallbacks"] == 1


def test_cuda_without_a_card_raises(port):
    assert all("CUDA is not available" in rank["cuda"] for rank in port)


def test_multihost_pair_returns_on_rank_0_only():
    img = _mkimg(16, 20, 9)
    (data0, out0, dry0), (data1, out1, dry1) = launch.run(
        worker.multihost_pair, 2, backend="gloo", device="cpu", args=(img,), timeout=TIMEOUT)
    assert data0 == oracle.encode_native(img) and data1 is None
    np.testing.assert_array_equal(out0, img)
    assert out1 is None
    assert dry0["bytes"] == dry1["bytes"] == len(oracle.encode_native(launch.dryrun_image(2)))
    # the lower shard of the dry run's image holds runs only: no real slot there
    assert (dry0["real_slots"] > 0, dry1["real_slots"]) == (True, 0)


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.run(worker.fail_on_rank_1, 2, backend="gloo", device="cpu", timeout=TIMEOUT)


def test_a_timeout_kills_every_rank():
    with pytest.raises(TimeoutError):
        launch.run(worker.sleep, 2, backend="gloo", device="cpu", args=(600,), timeout=6)


def test_nccl_without_cuda_raises_instead_of_using_gloo():
    with pytest.raises(RuntimeError, match="nccl"):
        initialize_distributed(backend="nccl", init_method="tcp://127.0.0.1:1", world_size=1, rank=0)
    with pytest.raises(ValueError):
        initialize_distributed(backend="mpi", init_method="tcp://127.0.0.1:1", world_size=1, rank=0)


@pytest.mark.parametrize("call", [
    lambda: launch.dryrun_multichip(1, timeout=TIMEOUT),
    lambda: launch.run(worker.sleep, 1, args=(0,), timeout=TIMEOUT),
    lambda: launch.run(worker.sleep, 1, backend="nccl", device="cpu", args=(0,), timeout=TIMEOUT),
])
def test_launcher_defaults_to_nccl_on_the_card_and_raises_without_it(call):
    """Called without a backend and a device, the launcher asks for NCCL on
    the card and raises where there is none, before any rank starts."""
    with pytest.raises(RuntimeError, match="nccl"):
        call()


def test_stage_spans_sum_host_seconds_into_stats(monkeypatch):
    """Each stage adds its host seconds to stats["stages"] and opens the
    span "<layer>.<stage>"; nothing waits for a device."""
    ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.75])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("a stage waited"))
    stats = {"stages": {"tables": 2.0}}
    stages = profiling.StageSpans("dist", stats)
    for name in ("walk", "tables", "walk"):
        with stages.stage(name):
            pass
    assert stats["stages"] == {"tables": 2.5, "walk": 1.0}
    assert stages.stages is stats["stages"]
    idle = profiling.StageSpans("dist")
    with idle.stage("walk"):  # without stats, no clock reading and no stage
        pass
    assert idle.stages is None


# the modules below the api, in the order they may import each other
LOWER = ("dist/comm", "dist/sharded", "dist/sharded_decode", "dist/multihost", "dist/launch", "dist/group",
         "pipeline")


def _imported(node) -> list[str]:
    """The modules an import statement names, `from a import b` as a.b."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.module:
        return [node.module] + [f"{node.module}.{a.name}" for a in node.names]
    return []


@pytest.mark.parametrize("module", LOWER)
def test_lower_layers_do_not_import_the_api(module):
    """The layers point one way: no module below the api imports it at any
    level, and no module imports a `dist` module inside a function, so that
    nothing dodges an import cycle."""
    path = os.path.join(os.path.dirname(nicetpu_torch.__file__), f"{module}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [n for node in ast.walk(tree) for n in _imported(node)]
    assert not [n for n in names if n == "nicetpu_torch.api" or n.startswith("nicetpu_torch.api.")]
    inner = [n for fn in ast.walk(tree) if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
             for node in ast.walk(fn) for n in _imported(node)]
    assert not [n for n in inner if n == "nicetpu_torch.dist" or n.startswith("nicetpu_torch.dist.")]
