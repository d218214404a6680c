"""The single-device decode's memory discipline: the decode core keeps only
each image's real pixels' slots after the coverage sums (`decode3._compact`)
and still gives `(out, ok, gates)` equal to the JAX core's, a gate failure
included; `decode_batch_v3` splits a same-shape batch into device batches
that fit a (here lowered) memory budget, with results and stats equal to
one batch's, and sends a stream that does not fit alone to the host,
counted, with the reason.  Exact comparisons throughout."""

import numpy as np
import torch

from nicetpu.format import constants as C
from nicetpu.hostref import oracle as joracle
from nicetpu_torch.kernels import cuda_ops
from nicetpu_torch.kernels import decode3 as td3
from nicetpu_torch.kernels.geometry import Geometry

from test_torch_decode_core import _both

H, W = 16, 128


CHUNK_BITS = 512  # every rung's chunk size here: short walks on the CPU


def _images():
    """Four 16 x 128 images; at 512-bit chunks the fast rung verifies the
    smooth one, the robust rung the long runs (few real slots), and no rung
    the noise (its chunks do not synchronise) or the 2-bit groups (no rung
    has the steps): the host decodes those."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (120 + 40 * np.sin(xx / 9.0) + 30 * np.cos(yy / 5.0)).astype(np.int32)
    smooth = np.clip(np.stack([base, base + 7, base - 9], -1) + rng.integers(-2, 3, (H, W, 3)), 0, 255)
    noise = rng.integers(0, 256, (H, W, 3))
    runs = np.zeros((H, W, 3), np.int64)
    runs[:, W // 2 :] = (30, 60, 90)
    runs[::4, ::16] = rng.integers(0, 256, (H // 4, W // 16, 3))
    abab = np.zeros((H, W, 3), np.int64)
    abab[:, 0::2] = (200, 10, 40)
    abab[:, 1::2] = (15, 220, 90)
    return [im.astype(np.uint8) for im in (smooth, noise, runs, abab)]


IMGS = _images()
DATAS = [joracle.encode_native(im) for im in IMGS]
LADDER = tuple(r._replace(chunk_bits=CHUNK_BITS) for r in td3.LADDER)


def test_compacted_core_matches_jax_with_a_gate_failure(monkeypatch):
    """Three streams with different counts of real slots, the third cut to
    half its payload: its coverage gate fails, alike in both packages (the
    robust rung's step budget at 512-bit chunks)."""
    counts = []
    compact = td3._compact

    def spy(real, arrays, fills):
        counts.append(real.sum(dim=1).tolist())
        return compact(real, arrays, fills)

    monkeypatch.setattr(td3, "_compact", spy)
    cut = (len(DATAS[0]) - C.FILE_HEADER_BYTES - C.STREAM_HEADERS_BYTES) // 2
    _, ok, gates = _both([DATAS[0], DATAS[2], DATAS[0][: len(DATAS[0]) - cut]],
                         chunk_bits=CHUNK_BITS, steps_div=3, rounds=3)
    assert ok.tolist() == [True, True, False]
    assert not gates[2, 2]  # coverage
    assert len(counts) == 1 and len(set(counts[0])) == 3, counts


def _decode(monkeypatch, budget):
    """decode_batch_v3 of the four streams under `budget`; returns the
    arrays, the stats and the batch size of each decode core call."""
    monkeypatch.setattr(td3, "device_budget", lambda device: budget)
    sizes = []
    core = td3._decode_core_v3

    def spy(words, *args, **kw):
        sizes.append(int(words.shape[0]))
        return core(words, *args, **kw)

    monkeypatch.setattr(td3, "_decode_core_v3", spy)
    stats: dict = {}
    out = td3.decode_batch_v3(DATAS, device=torch.device("cpu"), chunk_bits=CHUNK_BITS, stats=stats)
    for o, im in zip(out, IMGS):
        np.testing.assert_array_equal(o, im)
    return stats, sizes


def test_a_lowered_budget_splits_the_batch_with_equal_results(monkeypatch):
    whole, sizes = _decode(monkeypatch, None)
    assert sizes == [4, 4]  # one batch, both rungs
    assert whole["retries"] == 2 and whole["fallbacks"] == 2 and whole["ok"] == [True, False, True, False]
    longest = max(td3.payload_bits(d) // 8 for d in DATAS)
    two = 2 * td3.decode_bytes(longest, H * W, LADDER)
    split, sizes = _decode(monkeypatch, two)
    assert sizes == [2, 2, 2, 2]  # two batches on each rung
    assert split == whole


def test_a_stream_that_fits_no_budget_goes_to_the_host(monkeypatch):
    smallest = min(td3.decode_bytes(td3.payload_bits(d) // 8, H * W, LADDER) for d in DATAS)
    stats, sizes = _decode(monkeypatch, smallest - 1)
    assert sizes == []
    assert stats["fallbacks"] == 4 and stats["retries"] == 0
    assert [h["stream"] for h in stats["to_host"]] == [0, 1, 2, 3]
    assert all("GiB of device memory" in h["why"] for h in stats["to_host"])


def test_the_reckoning_covers_the_widest_rung():
    """decode_bytes counts the word array prepare_batch_args sizes and the
    larger of the slot phase, at the rung with the most slots, and the
    pixel phase."""
    nbytes = td3.payload_bits(DATAS[1]) // 8
    Wn = td3._words_cap(nbytes, td3.LADDER)
    slots = [(Wn - td3._wrows(r.chunk_bits)) // (r.chunk_bits // 32) * td3._steps(r.chunk_bits, r.steps_div)
             for r in td3.LADDER]
    assert slots[1] > slots[0]  # the robust rung's deep step budget
    assert td3.decode_bytes(nbytes, H * W) == 4 * Wn + max(td3.SLOT_BYTES * slots[1], td3.PIXEL_BYTES * H * W)
    assert td3.decode_bytes(nbytes, 10**9) == 4 * Wn + td3.PIXEL_BYTES * 10**9


def _spy_tables(monkeypatch) -> list:
    """(images, walk) of every table build; a call of derive_walk_tables,
    which would build the walk's tables again, raises."""
    built = []
    real = cuda_ops.decode_tables

    def tables(lens, *, walk=False):
        built.append((int(lens.shape[0]), walk))
        return real(lens, walk=walk)

    def derive(*args):
        raise AssertionError("the walk tables were derived again")

    monkeypatch.setattr(cuda_ops, "decode_tables", tables)
    monkeypatch.setattr(td3, "derive_walk_tables", derive)
    return built


def test_decode_builds_the_walk_tables_once_a_device_batch(monkeypatch):
    """Two device batches, each on both rungs: one build of all ten tables
    a device batch, which both rungs use."""
    built = _spy_tables(monkeypatch)
    two = 2 * td3.decode_bytes(max(td3.payload_bits(d) // 8 for d in DATAS), H * W, LADDER)
    stats, sizes = _decode(monkeypatch, two)
    assert sizes == [2, 2, 2, 2] and stats["retries"] == 2
    assert built == [(2, True), (2, True)]


def test_the_round_trip_builds_the_walk_tables_with_the_tables(monkeypatch):
    """The fused round trip builds all ten tables once for its fast rung,
    and the retry of the images it did not verify once for the later
    rungs."""
    built = _spy_tables(monkeypatch)
    stats: dict = {}
    flat = torch.from_numpy(np.stack(IMGS).reshape(len(IMGS), H * W, 3))
    _, _, verified = td3.roundtrip_verify_fused(flat, geom=Geometry.uniform(W, H * W, len(IMGS), "cpu"), stats=stats)
    assert stats["retries"] >= 1 and verified[0]
    assert built == [(4, True), (4, True)]
