"""`api.ShardGroup`, the persistent group of ranks, on the CPU over gloo:
one group of 2 and one of 4 ranks serve every call of this file (the
failure cases and the group's lifetime are in
`test_torch_shard_group_life.py`).  The bytes are held against
`hostref`, the decoded rasters against the images, and against the SPMD
entries (`encode_sharded`, `decode_sharded` and the `multihost` pair) on
the same rasters in one spawn of 2 ranks."""

import numpy as np
import pytest
import torch

from nicetpu_torch import api
from nicetpu_torch.dist import launch
from nicetpu_torch.hostref import oracle
from nicetpu_torch.utils import profiling

import _torch_dist_worker as worker

TIMEOUT = 120.0  # seconds a call or a collective may take before the group fails


def _rasters():
    """32 x 16 rasters: a run across the first shard edge of 2 and of 4
    ranks, a lower half of runs only, and noise."""
    rng = np.random.default_rng(21)
    base = (rng.integers(0, 4, (32, 16, 1)) * 60 + rng.integers(0, 3, (32, 16, 3))).astype(np.uint8)
    across = base.copy()
    across[6:19] = across[5, -1]  # rows 6-18: one run over the edges at rows 8 and 16
    runs_only = base.copy()
    runs_only[15:] = runs_only[14, -1]  # rank 1 of 2 holds one run from the one before
    noise = rng.integers(0, 256, (32, 16, 3), dtype=np.uint8)
    return {"run-across-edge": across, "shard-of-runs-only": runs_only, "noise": noise}


RASTERS = _rasters()
UNEVEN = RASTERS["noise"][:31]  # 31 rows: no split over 2 or 4 ranks
ROW_SOURCES = {"upload", "scatter"}  # where a rank's rows come from: the only stages the drivers differ in


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def group(request):
    """One group of 2 ranks, then one of 4: a process is rank 0 of one
    group at a time, and pytest runs every test of a parameter in turn."""
    with api.ShardGroup(request.param, device="cpu", timeout=TIMEOUT) as g:
        yield g


@pytest.fixture(scope="module")
def spmd():
    """Each rank's results of the SPMD entries on RASTERS, 2 gloo ranks."""
    return launch.run(worker.spmd_rasters, 2, backend="gloo", device="cpu", timeout=TIMEOUT,
                      args=(RASTERS, UNEVEN))


@pytest.mark.parametrize("name", list(RASTERS))
def test_roundtrip_bytes_proof_and_pixels(group, name):
    img, n = RASTERS[name], group.n
    stats: dict = {}
    data, verified, out = group.roundtrip(img, stats=stats, keep_decoded=True)
    assert data == oracle.encode_native(img)
    assert verified is True
    np.testing.assert_array_equal(out, img)
    assert (stats["rasters"], stats["fallbacks"], stats["overflow_fallbacks"], stats["host_served"]) == (1, 0, 0, 0)
    assert stats["device_stitches"] == 0  # the plain version stitches on the CPU
    assert stats["scattered_bytes"] == img.nbytes // n * (n - 1)
    assert len(stats["ranks"]) == n and stats["records_bytes"] > 0
    for r in stats["ranks"]:
        assert {"scatter", "halo", "pack", "walk", "records_all_gather", "carry_wait", "recon",
                "verify", "gather_decoded"} <= set(r["stage_ms"])
    assert {"upload", "stitch"} <= set(stats["ranks"][0]["stage_ms"])


@pytest.mark.parametrize("entry", ["roundtrip", "decode", "encode"])
def test_reconstruction_chains_reach_each_ranks_stats(group, entry):
    """Every rank reconstructs its block's three channel chains a decode,
    on one block each on the CPU (no cluster), and its counters reach the
    merged per-rank stats; an encode reconstructs none."""
    img = RASTERS["noise"]
    stats: dict = {}
    if entry == "roundtrip":
        group.roundtrip(img, stats=stats)
    elif entry == "decode":
        group.decode(oracle.encode_native(img), stats=stats)
    else:
        group.encode(img, stats=stats)
    chains = 0 if entry == "encode" else 3
    assert [(r["recon_chains"], r["recon_cluster_chains"]) for r in stats["ranks"]] == [(chains, 0)] * group.n


def test_encode_and_decode_alone(group):
    img = RASTERS["run-across-edge"]
    data = group.encode(img)
    assert data == oracle.encode_native(img)
    np.testing.assert_array_equal(group.decode(data), img)
    data, verified = group.roundtrip(img)  # without keep_decoded: two values
    assert verified is True and data == oracle.encode_native(img)


def test_a_height_that_does_not_split_is_a_counted_fallback(group):
    img = UNEVEN
    stats: dict = {}
    data, verified, out = group.roundtrip(img, stats=stats, keep_decoded=True)
    assert data == oracle.encode_native(img) and verified is True
    np.testing.assert_array_equal(out, img)
    assert (stats["fallbacks"], stats["host_served"], stats["rasters"]) == (1, 1, 1)
    assert "ranks" not in stats  # the group was not called


def test_helpers_record_spans_while_rank_0_is_traced(group):
    stats: dict = {}
    with profiling.recording():
        t0 = profiling.time.perf_counter()
        group.roundtrip(RASTERS["noise"], stats=stats)
        mine = profiling.spans(since=t0).total_ms
    assert {"dist.scatter", "dist.walk", "dist.verify"} <= set(mine)
    for r in stats["ranks"]:
        assert {"dist.scatter", "dist.halo", "dist.carry_wait", "dist.verify"} <= set(r["span_ms"])


def test_an_untraced_call_does_not_wait_for_the_device(group, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    stats: dict = {}
    group.roundtrip(RASTERS["run-across-edge"], stats=stats)
    assert calls == [] and "span_ms" not in stats["ranks"][0]


@pytest.mark.parametrize("name", list(RASTERS))
def test_spmd_encode_matches_the_group(group, spmd, name):
    """The SPMD encode gives the group's bytes (the bytes do not depend on
    the number of ranks) through the same stages once the rows are on the
    rank, and a broadcast of the bytes where every rank returns them."""
    stats: dict = {}
    data = group.encode(RASTERS[name], stats=stats)
    for r, rank in enumerate(spmd):
        everywhere, stages = rank[name]["encode_sharded"]
        root_only, root_stages = rank[name]["encode_multihost"]
        assert everywhere == data and root_only == (data if r == 0 else None)
        assert stages == root_stages | {"bytes_broadcast"}
        assert root_stages - ROW_SOURCES == set(stats["ranks"][r]["stage_ms"]) - ROW_SOURCES


@pytest.mark.parametrize("name", list(RASTERS))
def test_spmd_decode_matches_the_group(group, spmd, name):
    """The SPMD decode gives the group's raster through the same stages,
    the gather of the decoded blocks included, after the group's broadcast
    of rank 0's bytes."""
    stats: dict = {}
    out = group.decode(oracle.encode_native(RASTERS[name]), stats=stats)
    np.testing.assert_array_equal(out, RASTERS[name])
    for r, rank in enumerate(spmd):
        everywhere, stages = rank[name]["decode_sharded"]
        root_only, root_stages = rank[name]["decode_multihost"]
        np.testing.assert_array_equal(everywhere, out)
        if r == 0:
            np.testing.assert_array_equal(root_only, out)
        else:
            assert root_only is None
        assert stages == root_stages == set(stats["ranks"][r]["stage_ms"]) - {"bytes_broadcast"}


def test_spmd_encode_of_a_height_that_does_not_split_raises(spmd):
    """Where every rank holds the raster, a height that does not split is
    the caller's error; the group sends it to the host instead (above)."""
    assert all("must split" in rank["uneven"] for rank in spmd)
