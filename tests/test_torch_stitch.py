"""The sharded encode's stitch on the CPU (`cuda_ops.stitch_file`).

The plain version is held against `_file_bytes(header, *stitch_payload(...))`
and against the shards' bit strings written out one bit at a time; a Python
model of `stitch_kernel`'s schedule (`nicetpu_torch/csrc/stitch_kernels.cu`:
one thread a 16-byte chunk, the one-shard path and the edge path, which
shards cover each payload word, the header's bytes, the trailer) is held
against the plain version on the same cases.  Numpy and the port only."""

import os
import re

import numpy as np
import pytest
import torch

from _stitch_rows import CASES, HEADER_LENGTHS, bit_string, header, shards
from nicetpu_torch.dist import sharded
from nicetpu_torch.format import constants as C
from nicetpu_torch.format import headers
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import cuda_ops
from nicetpu_torch.spec import codec

CHUNK = 16  # file bytes a thread, as kChunk
MASK = 0xFFFFFFFF
SOURCE = os.path.join(os.path.dirname(sharded.__file__), "..", "csrc", "stitch_kernels.cu")


def _funnel(lo: int, hi: int, s: int) -> int:
    """__funnelshift_l(lo, hi, s): the high word of (hi:lo) << s."""
    return (((hi << 32) | lo) << s >> 32) & MASK


def kernel_model(words: torch.Tensor, bits, head: bytes) -> tuple[bytes, dict]:
    """What `stitch_kernel` writes, chunk by chunk as its threads do, and
    how many chunks took each path."""
    rows = words.numpy().view(np.uint32)
    n, k = rows.shape
    off = [0]
    for b in bits:
        off.append(off[-1] + int(b))
    total, hlen = off[n], len(head)
    length = hlen + total // 8 + 5
    out = bytearray(length)

    def word(d, i):
        assert 0 <= i < k, "read outside the shard's row"
        return int(rows[d, i])

    def shard_bits(d, b, y):
        nw = (b + 31) >> 5
        if y >= 0:
            i = y >> 5
            v = _funnel(word(d, i + 1) if i + 1 < nw else 0, word(d, i), y & 31)
            rem = b - y
            return v if rem >= 32 else v & (MASK << (32 - rem)) & MASK
        lead = -y
        v = word(d, 0) >> lead
        end = lead + b
        return v if end >= 32 else v & (MASK << (32 - end)) & MASK

    def shard_at(bit):
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) >> 1
            if off[mid + 1] > bit:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def payload_word(u):
        if u < 0:
            return 0
        lo, v, d = u << 5, 0, shard_at(u << 5)
        while d < n and off[d] < lo + 32:
            b = off[d + 1] - off[d]
            if b > 0:
                v |= shard_bits(d, b, lo - off[d])
            d += 1
        return v

    paths = {"inside": 0, "edge": 0}
    for at in range(0, length, CHUNK):
        x0 = (at - hlen) * 8
        d = shard_at(x0) if 0 <= x0 < total else n
        if d < n and x0 + 8 * CHUNK <= off[d + 1]:
            paths["inside"] += 1
            y = x0 - off[d]
            i, nw = y >> 5, (off[d + 1] - off[d] + 31) >> 5
            s = [word(d, i + j) if i + j < nw else 0 for j in range(5)]
            w = [_funnel(s[j + 1], s[j], y & 31) for j in range(4)]
        else:
            paths["edge"] += 1
            w = []
            for j in range(4):
                x = x0 + 32 * j
                w.append(_funnel(payload_word((x >> 5) + 1), payload_word(x >> 5), x & 31))
            nb = total >> 3
            for m in range(CHUNK):
                i = at + m
                if i < hlen:
                    v = head[i]
                elif i - hlen == nb + 1:
                    v = (payload_word(nb >> 2) >> (24 - 8 * (nb & 3))) & 0xFF
                else:
                    continue
                sh = 24 - 8 * (m & 3)
                w[m >> 2] = (w[m >> 2] & ~(0xFF << sh) & MASK) | (v << sh)
        chunk = b"".join(x.to_bytes(4, "big") for x in w)
        out[at : min(length, at + CHUNK)] = chunk[: length - at]
    return bytes(out), paths


def _reference(words: torch.Tensor, bits, head: bytes) -> bytes:
    flat = words.numpy().view(np.uint32).reshape(-1)
    return sharded._file_bytes(head, *sharded.stitch_payload(flat, np.asarray(bits, np.int64), words.shape[0]))


def _by_bits(words: torch.Tensor, bits, head: bytes) -> bytes:
    """The file from the payload's bits one by one."""
    s = bit_string(words, bits)
    nb = len(s) // 8
    whole = bytes(int(s[8 * i : 8 * i + 8], 2) for i in range(nb))
    B = int(s[8 * nb :].ljust(8, "0"), 2) if len(s) % 8 else 0
    return head + whole + bytes([B, B, 0, 0, 0])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_stitch_equals_file_bytes(case):
    bits, k = CASES[case]
    words, head = shards(bits, k, seed=len(case)), header(770)
    got = cuda_ops.stitch_file(words, bits, head)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert got.numel() == 770 + sum(bits) // 8 + 5
    assert got.numpy().tobytes() == _reference(words, bits, head) == _by_bits(words, bits, head)


@pytest.mark.parametrize("hlen", HEADER_LENGTHS)
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_equals_plain(case, hlen):
    bits, k = CASES[case]
    words, head = shards(bits, k, seed=hlen), header(hlen, seed=len(case))
    got, paths = kernel_model(words, bits, head)
    assert got == cuda_ops.stitch_file(words, bits, head).numpy().tobytes()
    # the edge path only over the header, across a shard's end (one chunk
    # each) and at the payload's end and the trailer
    assert paths["edge"] <= -(-hlen // CHUNK) + len(bits) + 2
    assert paths["inside"] + paths["edge"] == -(-len(got) // CHUNK)


def test_kernel_model_reads_no_bit_past_a_shards_total():
    """Bits past a shard's total are not read: random tails stitch as zero
    tails do (stitch_payload would OR them in)."""
    for case in ("four-ragged", "under-32-between", "four-under-32"):
        bits, k = CASES[case]
        clean, dirty = shards(bits, k, seed=3), shards(bits, k, seed=3, garbage=True)
        assert kernel_model(dirty, bits, header(770))[0] == _reference(clean, bits, header(770))


def test_a_shard_over_its_capacity_raises_before_any_launch():
    bits, k = CASES["four-ragged"]
    words = shards(bits, k)
    for over in ([32 * k + 1, 0, 0, 0], [0, 0, 0, 32 * k + 1]):
        with pytest.raises(ValueError, match="word capacity"):
            cuda_ops.stitch_file(words, over, header(770))
        with pytest.raises(ValueError, match="word capacity"):
            sharded.stitch_payload(words.numpy().view(np.uint32).reshape(-1), np.array(over), 4)
    assert cuda_ops.stitch_file(words, [32 * k, 0, 0, 0], header(770)).numel() == 770 + 4 * k + 5


def test_stitch_file_refuses_bad_inputs():
    words = shards([40, 50], 2)
    with pytest.raises(ValueError):
        cuda_ops.stitch_file(words, [40], b"")
    with pytest.raises(ValueError):
        cuda_ops.stitch_file(words, [40, -1], b"")
    with pytest.raises(TypeError):
        cuda_ops.stitch_file(words.to(torch.int64), [40, 50], b"")


def test_the_header_of_a_real_16_pixel_wide_file():
    """A file of 16 x 24 pixels from the host encoder: its header is
    `file_header`'s, 770 bytes (the payload starts 2 bytes past a 16-byte
    chunk), and its payload cut into shards at any bits stitches back to
    the same file, in the plain version and the kernel's model."""
    rng = np.random.default_rng(7)
    img = (rng.integers(0, 4, (24, 16, 1)) * 60 + rng.integers(0, 3, (24, 16, 3))).astype(np.uint8)
    data = oracle.encode_native(img)
    lengths = headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :])
    head = sharded.file_header(16, 24, lengths)
    assert len(head) == C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES == 770 and data[:770] == head
    total = int((codec.histogram(codec.tokenize(img)) * lengths.astype(np.int64)).sum())
    assert len(data) == 770 + total // 8 + 5
    payload = "".join(f"{b:08b}" for b in data[770 : 770 + -(-total // 8)])[:total]
    for n in (1, 2, 4):
        cuts = [0, *sorted(rng.integers(0, total + 1, n - 1).tolist()), total]
        parts = [payload[a:b] for a, b in zip(cuts, cuts[1:])]
        k = max(1, max(-(-len(p) // 32) for p in parts))
        rows = np.zeros((n, k), dtype=np.uint32)
        for d, p in enumerate(parts):
            p = p.ljust(32 * k, "0")
            rows[d] = [int(p[32 * i : 32 * i + 32], 2) for i in range(k)]
        words, bits = torch.from_numpy(rows.view(np.int32)), [len(p) for p in parts]
        assert cuda_ops.stitch_file(words, bits, head).numpy().tobytes() == data
        assert kernel_model(words, bits, head)[0] == data


def test_constants_match_the_kernel_source():
    src = open(SOURCE).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kMaxShards"), const("kMaxHeader"), const("kChunk")) == (
        cuda_ops.STITCH_MAX_SHARDS, cuda_ops.STITCH_MAX_HEADER, CHUNK)
    assert cuda_ops.LAUNCHES["stitch"] == 0  # the CPU runs the plain version
