"""`api.ShardGroup`'s failures and lifetime on the CPU over gloo: a
helper's exception and a call past its time limit fail the call with the
reason, and no way of ending a group leaves a process behind.  Each test
starts a group of its own (a process is rank 0 of one group at a time)."""

import gc
import os

import pytest
import torch

from nicetpu_torch import api
from nicetpu_torch.dist import sharded

import _torch_dist_worker as worker
from test_torch_shard_group import RASTERS, TIMEOUT


def _pids(g) -> list[int]:
    return [p.pid for p in g._state.procs]


def _alive(pids) -> list[int]:
    return [p for p in pids if os.path.exists(f"/proc/{p}")]


def _run(g, fn, *args):
    """fn(call, *args) on every rank of g."""
    return g._call(fn, args, args)


def test_a_helper_that_raises_fails_the_call_with_its_traceback():
    g = api.ShardGroup(2, device="cpu", timeout=TIMEOUT)
    pids = _pids(g)
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*ValueError: rank 1 fails on purpose"):
        _run(g, worker.group_fail_on_rank_1)
    with pytest.raises(RuntimeError, match="closed"):
        g.roundtrip(RASTERS["noise"])
    g.close()
    assert _alive(pids) == []


def test_a_call_past_its_time_limit_fails_and_kills_the_helpers():
    g = api.ShardGroup(2, device="cpu", timeout=TIMEOUT)
    pids = _pids(g)
    g.timeout = 2.0
    with pytest.raises(RuntimeError, match="time limit"):
        _run(g, worker.group_sleep_on_rank_1, 600)
    g.close()
    assert _alive(pids) == []


@pytest.mark.parametrize("how", ["close", "del", "with"])
def test_no_process_is_left_behind(how):
    if how == "with":
        with api.ShardGroup(2, device="cpu", timeout=TIMEOUT) as g:
            pids = _pids(g)
            assert _run(g, worker.sleep_group_rank) == 0
    else:
        g = api.ShardGroup(2, device="cpu", timeout=TIMEOUT)
        pids = _pids(g)
        assert _alive(pids) == pids
        if how == "close":
            g.close()
            g.close()  # idempotent
        else:
            del g
            gc.collect()
    assert _alive(pids) == []


def test_the_group_refuses_what_it_cannot_run():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.ShardGroup(2, device="cuda")
    with pytest.raises(ValueError, match="at least one rank"):
        api.ShardGroup(0, device="cpu")
    with pytest.raises(ValueError):
        api.ShardGroup(2, device="tpu")
    assert sharded.splits(32, 16, 4) and not sharded.splits(30, 16, 4)
    assert not sharded.splits(12, 16, 4) and not sharded.splits(32, 2, 2)
