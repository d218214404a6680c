"""The decode tables' two kernels (`csrc/decode_tables_kernels.cu`) on the CPU.

The kernels themselves run only on a card (`tests/test_torch_cuda.py`).
Here:
  * a numpy model of each kernel's algorithm, lane by lane.  decode_tables:
    a warp walks its stream in 32-symbol chunks, a symbol's rank among its
    length is the running count plus the lower lanes of its chunk with that
    length, the chunk's lowest such lane adds the group; the 32 lengths'
    counts and their code space (64 bits) are scanned with shuffles by 1, 2,
    4, 8 and 16 lanes; a symbol's slot is the count of shorter symbols plus
    its rank.  walk_tables: the suffix minimum by shuffles down, the last
    present length by a ballot, the forward fill by one shuffle;
  * both models against the plain versions (`prepare_tables_v3_plain`,
    `derive_walk_tables_plain`) and against JAX's `prepare_tables_v3_jnp`
    and `derive_walk_tables`, exactly, on every row of
    `tests/_decode_table_rows.py`.  JAX's int32 Kraft sum also accepts a
    nonzero multiple of 2^32 (the `kraft` row's 2 * 2^32); the port rejects
    it, as `validate_flat_lengths` does, and the test holds JAX to its own
    rule there.  JAX runs without 64-bit types, so the int64 rows past 2^32
    go to the model and the plain version only;
  * the wrappers on a CPU tensor: the plain version, no launch counted, and
    the inputs they refuse.

JAX is jitted once for all length rows together and once for all walk
rows, so that its CPU compiles stay two.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.kernels import decode3 as jd3
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


def model_stream(raw: np.ndarray):
    """One warp's stream: (n,) int64 raw lengths -> (af, present, ib (32,),
    order (n,), stream_max, ok)."""
    n = len(raw)
    in_range = bool(((raw >= 1) & (raw <= C.MAX_CODE_LEN)).all())
    lc = np.clip(raw, 1, C.MAX_CODE_LEN).astype(np.int64)
    run = [0] * LANES
    rank = np.zeros(n, np.int64)
    for p0 in range(0, n, LANES):
        chunk = [int(x) for x in lc[p0 : p0 + LANES]]
        for lane, ln in enumerate(chunk):  # __match_any_sync & the lower lanes
            rank[p0 + lane] = run[ln] + sum(1 for x in chunk[:lane] if x == ln)
        for ln in set(chunk):  # the group's lowest lane adds the group
            run[ln] += chunk.count(ln)
    count = run
    assert count[0] == 0
    space = [c << (32 - ln) for ln, c in enumerate(count)]
    incl = _warp_scan(count)
    space_incl = _warp_scan(space, MASK64)
    shorter = [i - c for i, c in zip(incl, count)]
    kraft = space_incl[-1]
    pres = [c > 0 for c in count]
    af = [(si - sp) & MASK32 if p else MASK32 for si, sp, p in zip(space_incl, space, pres)]
    ib = [s if p else 0 for s, p in zip(shorter, pres)]
    ballot = sum(1 << ln for ln, p in enumerate(pres) if p)
    order = np.full(n, -1, np.int64)
    for p in range(n):
        slot = shorter[lc[p]] + rank[p]
        assert order[slot] == -1, "two symbols in one slot"
        order[slot] = p
    assert (order >= 0).all()
    return (_i32(af), np.asarray(pres, np.int32), np.asarray(ib, np.int32), order, _highest(ballot),
            in_range and kraft == KRAFT)


def model_decode_tables(lens: np.ndarray):
    """(B, 858) int64 -> the seven outputs of `prepare_tables_v3`, as numpy."""
    B = lens.shape[0]
    af = np.zeros((B, C.NUM_STREAMS, LANES), np.int32)
    present, ib = np.zeros_like(af), np.zeros_like(af)
    pfx16 = np.zeros((B, 1, 16), np.int32)
    sym_tbl = np.zeros((B, C.TOTAL_SYMBOLS), np.int32)
    stream_max = np.zeros((B, C.NUM_STREAMS), np.int32)
    ok = np.ones(B, bool)
    for b in range(B):
        for s in range(C.NUM_STREAMS):
            base, n = C.STREAM_BASE[s], C.ALPHABET_SIZES[s]
            a, p, i, order, smax, good = model_stream(lens[b, base : base + n])
            af[b, s], present[b, s], ib[b, s] = a, p, i
            sym_tbl[b, base : base + n] = order
            if s == C.SC_PREFIXES:
                pfx16[b, 0, :n] = order
            stream_max[b, s] = smax
            ok[b] &= good
    return af, present, ib, pfx16, sym_tbl, stream_max, ok


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


@functools.lru_cache(maxsize=None)
def _jax_tables():
    """name -> JAX's seven outputs for that row, from one jitted call over
    every int32 row stacked."""
    stacked = np.concatenate([_rows(n) for n in INT32_ROWS]).astype(np.int32)
    outs = [np.asarray(x) for x in jax.jit(jd3.prepare_tables_v3_jnp)(jnp.asarray(stacked))]
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


@pytest.mark.parametrize("name,dtype", CASES, ids=[f"{n}-{str(d)[6:]}" for n, d in CASES])
def test_decode_tables_model_plain_and_jax_agree(name, dtype):
    lens = _rows(name)
    model = model_decode_tables(lens)
    plain = td3.prepare_tables_v3_plain(torch.from_numpy(lens).to(dtype))
    for g, w in zip(plain, model):
        _eq(g, w)
    if name in INT64_ONLY:
        return
    jax_out = _jax_tables()[name]
    for g, w in zip(model[:-1], jax_out[:-1]):
        _eq(g, w)
    # JAX's int32 Kraft sum wraps: it accepts in-range lengths whose every
    # stream sums to a multiple of 2^32; the port asks for exactly 2^32
    in_range = ((lens >= 1) & (lens <= C.MAX_CODE_LEN)).all(axis=1)
    wraps_to_zero = np.asarray([all(k % KRAFT == 0 for k in row) for row in kraft_sums(lens)])
    _eq(jax_out[-1], in_range & wraps_to_zero)


def test_rows_reach_every_case():
    """What the rows must hold for the kernel's edges to be tested."""
    lens = {name: _rows(name) for name in LENGTH_ROWS}
    ok = {name: model_decode_tables(x)[-1].tolist() for name, x in lens.items()}
    for name in ("valid", "sparse", "make_image", "soccer0", "deep", "B=1", "B=33"):
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
