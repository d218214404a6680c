"""The port's profilers and its multi-rank bench (`nicetpu_torch.bench_profile`,
`bench_decode_profile`, `bench_multihost`) in their CPU forms, with the
kernels' plain versions and tiny images: each exits 0 and prints the JAX
script's keys, its blobs have the lengths of the JAX package's bytes for
the same images, an inexact output fails the run, and the copied raster
equals the JAX script's."""

import json

import numpy as np
import pytest

import bench_multihost as jbench_multihost
from nicetpu.format import constants as JC
from nicetpu.hostref import oracle as joracle
from nicetpu.spec import codec as jcodec
from nicetpu_torch import bench, bench_decode_profile, bench_multihost, bench_profile

PROFILE_KEYS = {"B", "raw_mb", "comp_mb", "dispatch_ms", "dispatch_mbs", "payload_fetch_ms", "fetched_mb",
                "fetch_mbs_wire", "assemble_ms", "native_batch_decode_ms", "decode_mbs"}
DECODE_KEYS = {"B", "raw_mb", "kw", "prep_host_ms", "word_blocks_ms", "walk1_ms", "walks_all_rounds_ms",
               "no_recon_ms", "full_ms", "recon_ms_est", "assembly_ms_est", "full_mbs"}
MULTIHOST_KEYS = {"processes", "devices_per_proc", "mb_s", "efficiency_vs_1proc", "bytes", "note"}
PORT_KEYS = {"reps", "device", "card"}


def _payload_bytes(blob: bytes) -> int:
    """Whole payload bytes of a `.nice` stream: less the headers and the
    5-byte tail."""
    return len(blob) - JC.FILE_HEADER_BYTES - JC.STREAM_HEADERS_BYTES - 5


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def test_bench_profile_on_the_cpu(capsys):
    assert bench_profile.main(["--device", "cpu", "--side", "64", "--sizes", "2", "--reps", "1"]) == 0
    (ln,) = _lines(capsys)
    assert PROFILE_KEYS | PORT_KEYS <= set(ln)
    for stage in ("dispatch", "payload_fetch", "assemble", "native_batch_decode"):
        assert ln[f"{stage}_ms_fastest"] <= ln[f"{stage}_ms"] <= ln[f"{stage}_ms_slowest"]
    assert (ln["B"], ln["side"], ln["reps"], ln["device"]) == (2, 64, 1, "cpu")
    imgs = [bench.make_image(64, 64, s) for s in range(2)]
    blobs = [joracle.encode_native(im) for im in imgs]
    assert blobs == [jcodec.encode(im) for im in imgs]
    assert ln["comp_mb"] * 1e6 == pytest.approx(sum(len(b) for b in blobs), abs=1e-6)
    assert ln["raw_mb"] == sum(im.nbytes for im in imgs) / 1e6
    kmax = max(_payload_bytes(b) // 4 for b in blobs) + 2  # max(total) // 32 + 2
    assert ln["fetched_mb"] * 1e6 == pytest.approx(2 * 4 * kmax)
    assert ln["dispatch_mbs"] == pytest.approx(ln["raw_mb"] / (ln["dispatch_ms"] / 1e3))
    assert ln["fetch_mbs_wire"] == pytest.approx(ln["fetched_mb"] / (ln["payload_fetch_ms"] / 1e3))


def test_bench_profile_refuses_a_wrong_blob(monkeypatch):
    from nicetpu_torch.hostref import oracle

    real = oracle.encode_native
    monkeypatch.setattr(oracle, "encode_native", lambda img: real(img) + b"\0")
    with pytest.raises(AssertionError, match="differs from hostref"):
        bench_profile.run("cpu", sizes=(1,), side=16, reps=1, card="test")


def test_bench_decode_profile_on_the_cpu(capsys):
    assert bench_decode_profile.main(["--device", "cpu", "--side", "64", "--batch", "2", "--reps", "1"]) == 0
    (ln,) = _lines(capsys)
    assert DECODE_KEYS | PORT_KEYS <= set(ln)
    assert ln["word_blocks_ms"] is None
    assert ln["recon_ms_est"] == pytest.approx(ln["full_ms"] - ln["no_recon_ms"])
    assert ln["assembly_ms_est"] == pytest.approx(ln["no_recon_ms"] - ln["walks_all_rounds_ms"])
    assert ln["full_mbs"] == pytest.approx(ln["raw_mb"] / (ln["full_ms"] / 1e3))
    assert ln["kw"] == {"n_pixels": 64 * 64, "width": 64, "chunk_bits": 2048, "steps": 256, "rounds": 2}
    imgs = [bench.make_image(64, 64, s) for s in range(2)]
    assert ln["nch"] >= max(8 * _payload_bytes(jcodec.encode(im)) for im in imgs) // 2048


def test_bench_decode_profile_refuses_a_failed_gate(monkeypatch):
    from nicetpu_torch.kernels import decode3

    real = decode3._decode_core_v3

    def gate_fails(*a, **kw):
        out, ok, gates = real(*a, **kw)
        return out, ok & False, gates

    monkeypatch.setattr(decode3, "_decode_core_v3", gate_fails)
    with pytest.raises(AssertionError, match="ok is not all true"):
        bench_decode_profile.run("cpu", batch=1, side=16, reps=1, card="test")


def test_bench_multihost_on_the_cpu_at_1_and_2_ranks(capsys):
    """One spawn of 1 rank and one of 2: rank 0's bytes (checked against
    hostref inside the run) have the length of the JAX package's."""
    assert bench_multihost.main(["--device", "cpu", "--height", "32", "--width", "16", "--ranks", "1", "2",
                                 "--reps", "1"]) == 0
    lines = _lines(capsys)
    assert [ln["processes"] for ln in lines] == [1, 2]
    img = bench_multihost.make_image(32, 16)
    want = len(jcodec.encode(img))
    assert want == len(joracle.encode_native(img))
    for ln in lines:
        assert MULTIHOST_KEYS | PORT_KEYS <= set(ln)
        assert ln["bytes"] == want and ln["devices_per_proc"] == 1
        assert ln["mb_s"] == pytest.approx(img.nbytes / 1e6 / ln["secs"])
        assert "gloo" in ln["note"] and "not NVLink or NCCL" in ln["note"]
    assert lines[0]["efficiency_vs_1proc"] == 1.0
    assert lines[1]["efficiency_vs_1proc"] == pytest.approx(lines[1]["mb_s"] / lines[0]["mb_s"])


def test_multihost_raster_copy_matches_the_jax_script():
    img = bench_multihost.make_image()
    np.testing.assert_array_equal(img, jbench_multihost.make_image())
    assert img.shape == (1024, 512, 3) and img.dtype == np.uint8
