"""The decode tables' two kernels (`csrc/decode_tables_kernels.cu`) on the CPU.

The kernels themselves run only on a card (`tests/test_torch_cuda.py`).
Here:
  * a numpy model of each kernel's schedule, lane by lane.  decode_tables
    (all ten tables in one launch): one warp a 32-symbol chunk of a
    stream; a lane's rank is the lower lanes of its chunk with its length,
    the group's lowest lane stores the chunk's count; one warp a stream
    turns the chunks' counts into offsets (an exclusive scan over the
    stream's chunks) and scans the 32 lengths' counts and code space (64
    bits) with shuffles by 1, 2, 4, 8 and 16 lanes; a symbol's slot is the
    count of shorter symbols plus its chunk's offset plus its rank; the
    walk's tables from the same warp.  walk_tables: the suffix minimum by
    shuffles down, the last present length by a ballot, the forward fill by
    one shuffle;
  * both models against the plain versions (`prepare_tables_v3_plain`,
    `derive_walk_tables_plain`) and against JAX's `prepare_tables_v3_jnp`
    and `derive_walk_tables`, exactly, on every row of
    `tests/_decode_table_rows.py`, runs of equal lengths across chunk
    boundaries included.  JAX's int32 Kraft sum also accepts a nonzero
    multiple of 2^32 (the `kraft` row's 2 * 2^32); the port rejects it, as
    `validate_flat_lengths` does, and the test holds JAX to its own rule
    there.  JAX runs without 64-bit types, so the int64 rows past 2^32 go
    to the model and the plain version only;
  * the wrappers on a CPU tensor: the plain versions (the ten tables, and
    the seven alone), no launch counted, and the inputs they refuse; the
    one buffer's views; the kernel's chunk constants; `bench_decode_tables`'
    source edits.

JAX is jitted once for all length rows together and once for all walk
rows, so that its CPU compiles stay two.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.kernels import decode3 as jd3
from nicetpu_torch import bench_decode_tables
from nicetpu_torch.format import constants as C
from nicetpu_torch.format import huffman
from nicetpu_torch.kernels import cuda_ops
from nicetpu_torch.kernels import decode3 as td3

from _decode_table_rows import INT64_ONLY, KRAFT, LENGTH_ROWS, WALK_ROWS, kraft_sums, valid

LANES = 32
MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
I32_MAX = 2**31 - 1


def _i32(u):
    """uint32 values (Python ints or an int64 array) -> int32 bit patterns."""
    return (np.asarray(u, dtype=np.int64) & MASK32).astype(np.uint32).view(np.int32)


def _warp_scan(v, mask=None):
    """Inclusive warp scan as the kernel runs it: at each offset 1, 2, 4, 8,
    16, lane l adds lane l - off's value (lanes below off keep theirs)."""
    v = list(v)
    off = 1
    while off < LANES:
        v = [v[i] + v[i - off] if i >= off else v[i] for i in range(LANES)]
        if mask is not None:
            v = [x & mask for x in v]
        off *= 2
    return v


def _highest(bits: int) -> int:
    return bits.bit_length() - 1  # 31 - __clz; -1 for no bit


CHUNKS = [(s, p0) for s, n in enumerate(C.ALPHABET_SIZES) for p0 in range(0, n, LANES)]  # (stream, first symbol)


def _stream_chunks(s):
    return [c for c, (st, _) in enumerate(CHUNKS) if st == s]


def model_decode_tables(lens: np.ndarray):
    """(B, 858) int64 -> the ten outputs of `prepare_tables_v3(walk=True)`,
    as numpy, by the kernel's schedule: one block an image, one warp a
    32-symbol chunk of a stream.

      1. each lane reads its one length (int64 whole), range-checks and
         clamps it; its rank is the lower lanes of its chunk with the same
         length (__match_any_sync); the group's lowest lane writes the
         chunk's count of that length (s_at); a block-wide AND of the range
         checks (__syncthreads_and);
      2. one warp a stream, lane l length l: an exclusive scan over the
         stream's chunks turns s_at into offsets, the totals are the counts;
         the 64-bit warp scans give ib and af, the Kraft sum; the walk's
         tables from the warp's af, present and ib (`model_walk_tables`);
      3. each lane stores its symbol at ib[length] + its chunk's offset +
         its rank; lanes 13..15 of the prefix stream zero pfx16's pad."""
    B = lens.shape[0]
    af = np.zeros((B, C.NUM_STREAMS, LANES), np.int32)
    present, ib = np.zeros_like(af), np.zeros_like(af)
    pfx16 = np.full((B, 1, 16), -1, np.int32)
    sym_tbl = np.full((B, C.TOTAL_SYMBOLS), -1, np.int32)
    stream_max = np.zeros((B, C.NUM_STREAMS), np.int32)
    ok = np.ones(B, bool)
    for b in range(B):
        lc = np.zeros((len(CHUNKS), LANES), np.int64)  # 0: a lane past its stream's end
        rank = np.zeros_like(lc)
        s_at = np.zeros((len(CHUNKS), LANES), np.int64)
        in_range = True
        for c, (s, p0) in enumerate(CHUNKS):  # 1
            n, base = C.ALPHABET_SIZES[s], C.STREAM_BASE[s]
            for lane in range(LANES):
                if p0 + lane < n:
                    raw = int(lens[b, base + p0 + lane])
                    in_range &= 1 <= raw <= C.MAX_CODE_LEN
                    lc[c, lane] = min(max(raw, 1), C.MAX_CODE_LEN)
            for lane in range(LANES):
                same = [x for x in range(LANES) if lc[c, x] == lc[c, lane]]
                rank[c, lane] = sum(1 for x in same if x < lane)
                if lc[c, lane] and same[0] == lane:
                    s_at[c, lc[c, lane]] = len(same)
        shorter = np.zeros((C.NUM_STREAMS, LANES), np.int64)
        good = in_range
        for s in range(C.NUM_STREAMS):  # 2
            count = [0] * LANES
            for c in _stream_chunks(s):
                here = s_at[c].copy()
                s_at[c] = count
                count = [x + int(h) for x, h in zip(count, here)]
            assert count[0] == 0
            space = [k << (32 - ln) for ln, k in enumerate(count)]
            incl = _warp_scan(count)
            space_incl = _warp_scan(space, MASK64)
            shorter[s] = [i - k for i, k in zip(incl, count)]
            pres = [k > 0 for k in count]
            af[b, s] = _i32([(si - sp) & MASK32 if p else MASK32 for si, sp, p in zip(space_incl, space, pres)])
            present[b, s] = pres
            ib[b, s] = [sh if p else 0 for sh, p in zip(shorter[s], pres)]
            stream_max[b, s] = _highest(sum(1 << ln for ln, p in enumerate(pres) if p))
            good &= space_incl[-1] == KRAFT
        ok[b] = good
        for c, (s, p0) in enumerate(CHUNKS):  # 3
            n, base = C.ALPHABET_SIZES[s], C.STREAM_BASE[s]
            for lane in range(LANES):
                p = p0 + lane
                if p < n:
                    slot = int(shorter[s, lc[c, lane]] + s_at[c, lc[c, lane]] + rank[c, lane])
                    assert sym_tbl[b, base + slot] == -1, "two symbols in one slot"
                    sym_tbl[b, base + slot] = p
                    if s == C.SC_PREFIXES:
                        pfx16[b, 0, slot] = p
                elif s == C.SC_PREFIXES and p < 16:
                    pfx16[b, 0, p] = 0
    assert (sym_tbl >= 0).all() and (pfx16 >= 0).all()
    return (af, present, ib, pfx16, sym_tbl, stream_max, ok, *model_walk_tables(af, present, ib))


def model_walk_tables(af, present, ib):
    """(B, 10, 32) int32 words -> (aff, dD, inc), one warp a row of 32 lanes."""
    a = af.astype(np.int64) & MASK32
    pres = present != 0
    lane = np.arange(LANES)
    m = np.where(pres, (a ^ 0x80000000).astype(np.uint32).view(np.int32), I32_MAX).astype(np.int64)
    off = 1
    while off < LANES:  # __shfl_down_sync: lane l takes lane l + off's value
        down = np.concatenate([m[..., off:], m[..., -off:]], axis=-1)
        m = np.where(lane + off < LANES, np.minimum(m, down), m)
        off *= 2
    d_at = np.where(pres, ((ib.astype(np.int64) & MASK32) - (a >> ((32 - lane) & 31))) & MASK32, 0)
    ballot = (pres.astype(np.int64) << lane).sum(axis=-1)  # (B, 10)
    aff, dD, inc = (np.zeros(af.shape, np.int64) for _ in range(3))
    for idx in np.ndindex(af.shape[:-1]):
        bits = int(ballot[idx])
        last = [_highest(bits & ((2 << ln) - 1)) for ln in range(LANES)]
        d_ff = [int(d_at[idx][ln]) if ln >= 0 else 0 for ln in last]
        prev = [0] + d_ff[:-1]
        longest = max(_highest(bits), 0)
        aff[idx] = m[idx]
        dD[idx] = [(x - y) & MASK32 for x, y in zip(d_ff, prev)]
        inc[idx] = lane <= longest
    return aff.astype(np.int32), _i32(dD), inc.astype(np.int32)


# ---------------------------------------------------------------------------
# JAX, once for every row together
# ---------------------------------------------------------------------------

INT32_ROWS = [name for name in LENGTH_ROWS if name not in INT64_ONLY]


@functools.lru_cache(maxsize=None)
def _rows(name):
    return LENGTH_ROWS[name]()


def _jax_ten(lens):
    """JAX's `prepare_tables_v3_jnp` and `derive_walk_tables` of its tables."""
    tables = jd3.prepare_tables_v3_jnp(lens)
    return (*tables, *jd3.derive_walk_tables(*tables[:3]))


@functools.lru_cache(maxsize=None)
def _jax_tables():
    """name -> JAX's ten outputs for that row (`_jax_ten`), from one jitted
    call over every int32 row stacked."""
    stacked = np.concatenate([_rows(n) for n in INT32_ROWS]).astype(np.int32)
    outs = [np.asarray(x) for x in jax.jit(_jax_ten)(jnp.asarray(stacked))]
    cuts = np.cumsum([0] + [len(_rows(n)) for n in INT32_ROWS])
    return {n: [x[a:b] for x in outs] for n, a, b in zip(INT32_ROWS, cuts[:-1], cuts[1:])}


def _walk_inputs():
    """name -> (af, present, ib): the random words, and the plain version's
    tables of every length row."""
    out = {name: f() for name, f in WALK_ROWS.items()}
    for name in LENGTH_ROWS:
        af, pr, ib, *_ = td3.prepare_tables_v3_plain(torch.from_numpy(_rows(name)))
        out[f"tables of {name}"] = (af.numpy(), pr.numpy(), ib.numpy())
    return out


@functools.lru_cache(maxsize=None)
def _jax_walk():
    inputs = _walk_inputs()
    names = list(inputs)
    stacked = [np.concatenate([inputs[n][k] for n in names]) for k in range(3)]
    outs = [np.asarray(x) for x in jax.jit(jd3.derive_walk_tables)(*map(jnp.asarray, stacked))]
    cuts = np.cumsum([0] + [len(inputs[n][0]) for n in names])
    return {n: (inputs[n], [x[a:b] for x in outs]) for n, a, b in zip(names, cuts[:-1], cuts[1:])}


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# decode_tables
# ---------------------------------------------------------------------------

CASES = [(name, dtype) for name in LENGTH_ROWS for dtype in (torch.int32, torch.int64)
         if dtype == torch.int64 or name not in INT64_ONLY]


def _plain_pair(lens):
    """`prepare_tables_v3_plain` and `derive_walk_tables_plain` of its tables."""
    tables = td3.prepare_tables_v3_plain(lens)
    return tables + td3.derive_walk_tables_plain(*tables[:3])


def _hold_to_jax(name, got):
    """The ten tables against JAX's on an int32 row: equal but for
    tables_ok where JAX's int32 Kraft sum wraps (it accepts in-range
    lengths whose every stream sums to a multiple of 2^32; the port asks
    for exactly 2^32)."""
    lens = _rows(name)
    jax_out = _jax_tables()[name]
    for k, (g, w) in enumerate(zip(got, jax_out)):
        if k != 6:
            _eq(g, w)
    in_range = ((lens >= 1) & (lens <= C.MAX_CODE_LEN)).all(axis=1)
    wraps_to_zero = np.asarray([all(k % KRAFT == 0 for k in row) for row in kraft_sums(lens)])
    _eq(jax_out[6], in_range & wraps_to_zero)


@pytest.mark.parametrize("name,dtype", CASES, ids=[f"{n}-{str(d)[6:]}" for n, d in CASES])
def test_decode_tables_model_plain_and_jax_agree(name, dtype):
    """The kernel's schedule (all ten tables) against the plain pair and JAX's."""
    lens = _rows(name)
    model = model_decode_tables(lens)
    plain = _plain_pair(torch.from_numpy(lens).to(dtype))
    assert len(model) == len(plain) == 10
    for g, w in zip(plain, model):
        _eq(g, w)
    if name not in INT64_ONLY:
        _hold_to_jax(name, model)


@pytest.mark.parametrize("name,dtype", CASES, ids=[f"{n}-{str(d)[6:]}" for n, d in CASES])
def test_fused_wrapper_on_the_cpu_equals_the_plain_pair_and_jax(name, dtype):
    """`prepare_tables_v3(walk=True)` on a CPU tensor: the seven tables and
    the walk's three, bit for bit, and no launch counted."""
    lens = torch.from_numpy(_rows(name)).to(dtype)
    before = dict(cuda_ops.LAUNCHES)
    got = td3.prepare_tables_v3(lens, walk=True)
    assert cuda_ops.LAUNCHES == before
    want = _plain_pair(lens)
    assert len(got) == 10 and [g.dtype for g in got] == [w.dtype for w in want]
    for g, w in zip(got, want):
        _eq(g, w)
    for g, w in zip(td3.prepare_tables_v3(lens), want[:7]):  # the seven alone
        _eq(g, w)
    if name not in INT64_ONLY:
        _hold_to_jax(name, got)


@pytest.mark.parametrize("B,walk", [(1, True), (3, False), (5, True), (8, True), (33, False)])
def test_one_buffer_carves_into_the_ten_tables(B, walk):
    """The wrapper's one allocation, filled as the kernel fills it (af,
    present, ib, pfx16, sym_tbl, stream_max, [aff, dD, inc,] as int32 words,
    then tables_ok's bytes), gives back the tables as contiguous views."""
    want = _plain_pair(torch.from_numpy(valid(B, B)))[: 10 if walk else 7]
    ints = [t for k, t in enumerate(want) if k != 6]
    layout, ok_at, nbytes = cuda_ops._table_layout(B, walk)
    assert [shape for shape, _, _ in layout] == [tuple(t.shape) for t in ints]
    assert ok_at == 4 * sum(t.numel() for t in ints) and nbytes % 4 == 0 and ok_at + B <= nbytes < ok_at + B + 4
    buf = torch.zeros(nbytes, dtype=torch.bool)
    buf.view(torch.int32)[: ok_at // 4] = torch.cat([t.flatten() for t in ints])
    buf[ok_at : ok_at + B] = want[6]
    got = cuda_ops._carve_tables(buf, B, walk)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous()
        assert g.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        _eq(g, w)


def test_kernel_chunks_match_the_streams():
    """The kernel's chunk tables (`kFirstChunk`, `kChunkStream`) and stream
    sizes and bases, read from its source, are the model's."""
    path = os.path.join(os.path.dirname(td3.__file__), "..", "csrc", "decode_tables_kernels.cu")
    with open(path) as f:
        src = f.read()

    def table(name):
        body = re.search(rf"__constant__ int {name}\[[^]]*\] = {{([^}}]*)}}", src).group(1)
        return [int(x) for x in body.replace("\n", " ").split(",")]

    assert table("kSizes") == list(C.ALPHABET_SIZES) and table("kBase") == list(C.STREAM_BASE)
    assert table("kChunkStream") == [s for s, _ in CHUNKS]
    assert table("kFirstChunk") == [_stream_chunks(s)[0] for s in range(C.NUM_STREAMS)] + [len(CHUNKS)]
    assert f"kChunks = {len(CHUNKS)};" in src


def test_rows_reach_every_case():
    """What the rows must hold for the kernel's edges to be tested."""
    lens = {name: _rows(name) for name in LENGTH_ROWS}
    ok = {name: model_decode_tables(x)[6].tolist() for name, x in lens.items()}
    for name in ("valid", "sparse", "make_image", "soccer0", "deep", "straddle", "B=1", "B=33"):
        assert all(ok[name]), name
    assert ok["single_length"] == [True, False, False]
    assert ok["bad_values"] == ok["past_2_32"] == ok["kraft"] == [False] * 3
    assert all((row == C.MAX_CODE_LEN).any() for row in lens["deep"])  # 31-bit codes in every row
    assert {0, 32, -1} <= set(np.unique(lens["bad_values"]).tolist())
    assert ((lens["past_2_32"] > I32_MAX) | (lens["past_2_32"] < -(2**31))).any(axis=1).all()  # no int32
    assert (lens["past_2_32"] % 2**32 == valid(25)).all()  # the low words: valid lengths
    sums = kraft_sums(lens["kraft"])
    assert [min(r) < KRAFT for r in sums] == [True, False, False]
    assert max(sums[1]) > KRAFT and max(sums[1]) % KRAFT and max(sums[2]) == 2 * KRAFT
    assert len(lens["B=1"]) == 1 and len(lens["B=33"]) == 33
    # straddle: in both rows, RGB's and stream 5's runs of equal lengths
    # cross chunk boundaries, and most chunks hold two lengths or more
    for s in (C.SC_RGB, 5):
        cut = slice(C.STREAM_BASE[s], C.STREAM_BASE[s] + C.ALPHABET_SIZES[s])
        for row in lens["straddle"][:, cut]:
            crossing = [p for p in range(LANES, len(row), LANES) if row[p - 1] == row[p]]
            assert len(crossing) >= 3, (s, crossing)
            mixed = [len(set(row[p : p + LANES])) >= 2 for p in range(0, len(row), LANES)]
            assert 2 * sum(mixed) > len(mixed), (s, mixed)
    # the make_image and soccer0 rows are real encodes' headers
    for name in ("make_image", "soccer0"):
        for row in lens[name]:
            huffman.validate_flat_lengths(row)


def test_wrapper_runs_the_plain_version_on_the_cpu(monkeypatch):
    lens = torch.from_numpy(_rows("kraft"))
    before = dict(cuda_ops.LAUNCHES)
    got = td3.prepare_tables_v3(lens)
    for g, w in zip(got, td3.prepare_tables_v3_plain(lens)):
        _eq(g, w)
    af, pr, ib = got[:3]
    for g, w in zip(td3.derive_walk_tables(af, pr, ib), td3.derive_walk_tables_plain(af, pr, ib)):
        _eq(g, w)
    assert cuda_ops.LAUNCHES == before  # the CPU runs the plain versions: no launch

    def boom(*a):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(td3, "prepare_tables_v3_plain", boom)
    with pytest.raises(AssertionError, match="plain version reached"):
        td3.prepare_tables_v3(lens)


BAD_LENS = {
    "float": lambda: torch.zeros(2, 858), "int16": lambda: torch.zeros(2, 858, dtype=torch.int16),
    "857 columns": lambda: torch.zeros(2, 857, dtype=torch.int64),
    "B = 0": lambda: torch.zeros(0, 858, dtype=torch.int32), "1-D": lambda: torch.zeros(858, dtype=torch.int32),
    "numpy": lambda: np.zeros((2, 858), np.int32), "meta": lambda: torch.zeros(2, 858, dtype=torch.int32, device="meta"),
}


@pytest.mark.parametrize("bad", sorted(BAD_LENS))
def test_decode_tables_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        cuda_ops.decode_tables(BAD_LENS[bad]())


# ---------------------------------------------------------------------------
# walk_tables
# ---------------------------------------------------------------------------

WALK_NAMES = list(WALK_ROWS) + [f"tables of {name}" for name in LENGTH_ROWS]


@pytest.mark.parametrize("name", WALK_NAMES)
def test_walk_tables_model_plain_and_jax_agree(name):
    (af, pr, ib), jax_out = _jax_walk()[name]
    model = model_walk_tables(af, pr, ib)
    plain = td3.derive_walk_tables_plain(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (af, pr, ib)))
    for g, m, j in zip(plain, model, jax_out):
        _eq(g, m)
        _eq(m, j)


def test_walk_rows_reach_every_case():
    af, pr, ib = WALK_ROWS["random"]()
    assert not pr[1, 4].any() and pr[2, 7].all()
    assert ((pr != 0) & (pr != 1)).any()  # any nonzero word means present
    aff, _, inc = model_walk_tables(af, pr, ib)
    assert inc[1, 4].tolist() == [1] + [0] * 31 and (aff[1, 4] == I32_MAX).all()
    af, pr, ib = WALK_ROWS["edges"]()
    assert pr[0, 0].tolist() == [1] + [0] * 31 and pr[0, 1].tolist() == [0] * 31 + [1]


def _walk_words(B=2):
    return tuple(torch.from_numpy(x[:B].copy()) for x in WALK_ROWS["random"]())


BAD_WALK = {
    "int64": lambda af, pr, ib: (af.to(torch.int64), pr, ib),
    "31 lengths": lambda af, pr, ib: (af[..., :31].contiguous(), pr[..., :31].contiguous(), ib[..., :31].contiguous()),
    "9 streams": lambda af, pr, ib: (af[:, :9].contiguous(), pr[:, :9].contiguous(), ib[:, :9].contiguous()),
    "2-D": lambda af, pr, ib: (af[0], pr[0], ib[0]),
    "B differs": lambda af, pr, ib: (af, pr[:1].contiguous(), ib),
    "not contiguous": lambda af, pr, ib: (af.repeat_interleave(2, -1)[..., ::2], pr, ib),
    "B = 0": lambda af, pr, ib: (af[:0], pr[:0], ib[:0]),
    "mixed devices": lambda af, pr, ib: (af, pr.to("meta"), ib),
}


@pytest.mark.parametrize("bad", sorted(BAD_WALK))
def test_walk_tables_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        cuda_ops.walk_tables(*BAD_WALK[bad](*_walk_words()))


@pytest.mark.parametrize("variant", sorted(bench_decode_tables.VARIANTS))
def test_bench_variants_still_apply(variant):
    """`bench_decode_tables` edits copies of the kernel's source: each edit
    still applies exactly once, and only `committed` is the source."""
    with open(os.path.join(os.path.dirname(td3.__file__), "..", "csrc", "decode_tables_kernels.cu")) as f:
        committed = f.read()
    assert (bench_decode_tables.variant_source(variant) == committed) == (variant == "committed")


def test_bench_decode_tables_needs_a_card_and_calls_the_ten_tables(monkeypatch, capsys):
    """The bench exits 1 without a card, printing no result; on this tree
    its tables call is `prepare_tables_v3(walk=True)`, the ten tables.  Its
    timer adds each wrapped call's seconds and passes results through."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_decode_tables.main(["--host-only"]) == 1
    assert capsys.readouterr().out == ""
    lens = torch.from_numpy(_rows("valid"))
    for g, w in zip(bench_decode_tables.tables_call()(lens), _plain_pair(lens)):
        _eq(g, w)
    timed = bench_decode_tables.Timed(lambda a, b=0: a + b)
    assert timed(2, b=3) == 5 and timed(1) == 1
    assert timed.seconds > 0
