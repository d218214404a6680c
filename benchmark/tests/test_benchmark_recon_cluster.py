"""The reader of `dist.recon_cluster_pct`: the share of the reconstruction's
chains that ran on a thread-block cluster, from the counters each rank of
the group sends back."""

from __future__ import annotations

import pytest
import torch

import _tiny
from benchmark import run
from benchmark.spec import Spec

NAME = "dist.recon_cluster_pct"


def _read(stats, device="cuda"):
    ctx = run.Ctx(device=torch.device(device))
    ctx.stats = stats
    return Spec(_tiny.REPO).module("metrics", NAME).read(ctx)


@pytest.mark.parametrize("stats", [
    {},
    {"rasters": 1},
    {"ranks": []},
    {"ranks": [{"peak_device_bytes": 1, "records_bytes": 8}] * 4},  # a program without the counters
    {"ranks": [{"recon_chains": 3}, {"records_bytes": 8}]},  # a rank without them
    {"ranks": [{"recon_chains": 0, "recon_cluster_chains": 0}] * 4},  # no decode in the window
], ids=["empty", "no-ranks", "zero-ranks", "no-counters", "one-rank-without", "no-chains"])
def test_reads_nothing_without_chains(stats):
    assert _read(stats) is None


def test_reads_nothing_on_the_cpu():
    assert _read({"ranks": [{"recon_chains": 6, "recon_cluster_chains": 0}] * 2}, device="cpu") is None


@pytest.mark.parametrize("cluster,want", [((6, 6, 6, 6), 100.0), ((0, 0, 0, 0), 0.0), ((6, 0, 6, 0), 50.0),
                                          ((3, 0, 0, 0), 12.5)])
def test_the_share_over_every_rank(cluster, want):
    ranks = [{"recon_chains": 6, "recon_cluster_chains": c} for c in cluster]
    assert _read({"ranks": ranks, "group_calls": 2}) == pytest.approx(want)


def test_the_metric_is_declared_for_the_four_card_cell():
    spec = Spec(_tiny.REPO)
    (m,) = [m for m in spec.bench["per_layer"] if m["name"] == NAME]
    assert (m["layer"], m["moves"], m["source"], m["workloads"]) == (
        "kernels", "raw_MBps", "program_counter", ["raster16k-sharded4"])
    assert NAME in [x["name"] for x in spec.metrics("raster16k-sharded4", True)]
    assert NAME not in [x["name"] for x in spec.metrics("kodak24-decode", True)]
