"""Payloads of 2**31 bits or more, on the CPU, without a stream that size.

A single-device decode sends a stream of `decode3.MAX_DEVICE_BITS` bits or
more to the host codec, counted in `fallbacks`; the tests lower the limit
between two small streams.  The sharded decode keeps the walk's positions
relative to each shard (`sharded_decode.shard_walk`) and its gates in int64
(`sharded_decode.walk_gates`); the tests walk a small slice re-based past
2**31 and hold it against the same slice at its own offset, shifted, and
hold the gates against Python integers around 2**31.  The JAX package's
decode shares the int32 bit count, so past 2**31 the port is held to
`hostref`, not to JAX."""

import numpy as np
import pytest
import torch

import nicetpu_torch
from nicetpu_torch.dist import sharded_decode as tsd
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import decode3 as td3

from test_torch_decode import _image, _payload_words, _t


def _pair():
    """Two same-shape images, a smooth one and a noisy one, and their
    streams; the noisy stream's payload is the larger."""
    smooth = _image(16, 32, seed=4)
    noisy = np.random.default_rng(5).integers(0, 256, (16, 32, 3)).astype(np.uint8)
    imgs = [smooth, noisy]
    blobs = [oracle.encode_native(im) for im in imgs]
    bits = [td3.payload_bits(b) for b in blobs]
    assert bits[0] < bits[1]
    return imgs, blobs, bits


@pytest.fixture
def host_decodes(monkeypatch):
    """Counts the host codec's decodes."""
    calls = []
    real = oracle.decode_native

    def counted(data):
        calls.append(len(data))
        return real(data)

    monkeypatch.setattr(oracle, "decode_native", counted)
    return calls


@pytest.mark.parametrize("entry", ["decode_batch_v3", "api.decode_batch"])
def test_a_stream_over_the_limit_decodes_on_the_host_counted(monkeypatch, host_decodes, entry):
    imgs, blobs, bits = _pair()
    monkeypatch.setattr(td3, "MAX_DEVICE_BITS", bits[1] - 8)  # the noisy payload is over it
    stats: dict = {}
    if entry == "decode_batch_v3":
        out = td3.decode_batch_v3(blobs, device=torch.device("cpu"), stats=stats)
    else:
        out = nicetpu_torch.decode_batch(blobs, device="cpu", stats=stats)
    for o, im in zip(out, imgs):
        np.testing.assert_array_equal(o, im)
    assert stats["fallbacks"] == 1 and stats["retries"] == 0
    assert host_decodes == [len(blobs[1])]
    with pytest.raises(ValueError, match="host"):
        td3.prepare_batch_args(blobs, device=torch.device("cpu"))


def test_streams_under_the_limit_stay_on_the_device(host_decodes):
    imgs, blobs, _ = _pair()
    stats: dict = {}
    out = td3.decode_batch_v3(blobs, device=torch.device("cpu"), stats=stats)
    for o, im in zip(out, imgs):
        np.testing.assert_array_equal(o, im)
    assert stats["fallbacks"] == 0 and host_decodes == []


def test_the_round_trip_leaves_a_payload_over_the_limit_to_the_host(monkeypatch):
    """The fused round trip neither verifies on the device nor retries an
    image at or over the limit (its walk covers only the first
    MAX_DEVICE_BITS bits); the host proves it, counted."""
    imgs, blobs, bits = _pair()
    monkeypatch.setattr(td3, "MAX_DEVICE_BITS", bits[1] - 8)  # below its exact bit count
    stats: dict = {}
    datas, verified = nicetpu_torch.roundtrip_batch(imgs, device="cpu", stats=stats)
    assert datas == blobs
    assert verified.tolist() == [True, False]
    assert stats["fallbacks"] == 1 and stats["retries"] == 0 and stats["overflow_fallbacks"] == 0


def test_the_walk_geometry_stops_at_the_limit(monkeypatch):
    monkeypatch.setattr(td3, "MAX_DEVICE_BITS", 10_000)
    cfg = td3.LADDER[0]
    assert td3._wcap_one(10**6, cfg) == td3._wcap_one(10_000 // 8, cfg)
    assert td3._wcap_one(100, cfg) < td3._wcap_one(10_000 // 8, cfg)


OFFSET_CHUNKS = 2**31 // 512 + 3  # chunks of 512 bits past 2**31


def test_rebased_walk_past_2_31_equals_the_walk_at_its_own_offset():
    """A shard whose first bit lies past 2**31: the same slice walked with
    every global position moved by OFFSET_CHUNKS chunks gives the same
    records (relative positions) and the exits moved by the same amount,
    in the second round, whose entries cross the shard boundaries."""
    data = oracle.encode_native(_image(64, 96, seed=2))
    lengths, words, wbits = _payload_words(data, 0)
    chunk_bits, n = 512, 4
    nlc, steps = tsd.shard_geometry(wbits, n, td3.WalkCfg(chunk_bits, 8, 3, 3))
    af, pr, ib, pfx, *_ = td3.prepare_tables_v3(_t(lengths[None]))
    tables = (*td3.derive_walk_tables(af, pr, ib), pfx)
    payload = data[-4 - wbits // 8 : -4]
    slices = [_t(tsd.shard_words(payload, d, nlc, chunk_bits).view(np.int32)[None]) for d in range(n)]
    shift = OFFSET_CHUNKS * chunk_bits
    assert shift > 2**31
    kw = dict(span=nlc * chunk_bits, chunk_bits=chunk_bits, steps=steps)
    e = torch.arange(n * nlc, dtype=torch.int64)[None] * chunk_bits
    ex = torch.cat([tsd.shard_walk(slices[d], e[:, d * nlc : (d + 1) * nlc], tables, wbits,
                                   base=d * nlc * chunk_bits, records=False, **kw)[1]
                    for d in range(n)], dim=1)
    e = torch.cat([torch.zeros_like(ex[:, :1]), ex[:, :-1]], dim=1)  # round 2's entries
    for d in range(n):
        base = d * nlc * chunk_bits
        ed = e[:, d * nlc : (d + 1) * nlc]
        recs, ex = tsd.shard_walk(slices[d], ed, tables, wbits, base=base, **kw)
        recs_far, ex_far = tsd.shard_walk(slices[d], ed + shift, tables, wbits + shift,
                                          base=base + shift, **kw)
        for a, b in zip(recs, recs_far):
            assert torch.equal(a, b)
        assert torch.equal(ex_far, ex + shift)
        assert int(ex_far.min()) > 2**31


def _gates_ref(e, ex2, prev, wbits, base, chunk_bits, first):
    """walk_gates in Python integers."""
    nlc = len(e)
    ok_in = all(ex2[i] == e[i + 1] or ex2[i] >= wbits for i in range(nlc - 1))
    first_ok = first or prev == e[0] or prev >= wbits
    crossed = all(ex2[i] >= min(base + (i + 1) * chunk_bits, wbits) or e[i] >= wbits
                  for i in range(nlc))
    return ok_in and first_ok and crossed


CB = 2048
BASE = 2**31 - 2 * CB  # the shard's chunks straddle 2**31


def _walked(nlc=4):
    e = [BASE + i * CB + 5 * (i > 0) for i in range(nlc)]
    ex2 = e[1:] + [BASE + nlc * CB + 5]
    return e, ex2


@pytest.mark.parametrize("case", ["clean", "wbits under 2**31", "wbits at 2**31", "wbits over 2**31",
                                  "exit off by 2**32", "entry off by 2**32", "short exit",
                                  "previous exit off"])
def test_walk_gates_hold_in_int64_around_2_31(case):
    e, ex2 = _walked()
    prev, wbits, first = e[0], BASE + 4 * CB + 100, False
    if case == "wbits under 2**31":
        wbits = 2**31 - 1
    elif case == "wbits at 2**31":
        wbits = 2**31
    elif case == "wbits over 2**31":
        wbits = 2**31 + 1
    elif case == "exit off by 2**32":
        ex2[1] -= 2**32  # equal to the next entry in int32
    elif case == "entry off by 2**32":
        e[3] += 2**32
    elif case == "short exit":
        ex2[2] = BASE + 3 * CB - 1  # did not cross its bound
        e[3] = ex2[2]
    elif case == "previous exit off":
        prev = e[0] - 2**32
    want = _gates_ref(e, ex2, prev, wbits, BASE, CB, first)
    got = tsd.walk_gates(torch.tensor(e), torch.tensor(ex2), torch.tensor(prev), wbits, base=BASE,
                         chunk_bits=CB, first=first)
    assert got.shape == (2,) and bool(got.all()) == want
    assert want == (case in ("clean", "wbits under 2**31", "wbits at 2**31", "wbits over 2**31"))
