"""The decode core's slot assembly (`cuda_ops.slot_assemble`,
`csrc/slot_assemble_kernels.cu`) on the CPU.

A Python model of the three kernels' schedule (warps of 32 lanes taking 4
slots each, shuffle scans in their order, the packed scan state, the chunk
summaries with only 11 leading symbols, the per-image pass in tiles of 512
chunks with its block scans, the one chunk across N counted again, the
compaction at ranks and the fills) is held against the plain version
`decode3.slot_assemble_plain` on random and adversarial records; the wrapper
on CPU tensors is the plain version, and its starts and coverage gate equal
JAX's `assemble_v3` on a real stream.  Exact comparisons throughout."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.kernels import decode3 as jd3
from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels import cuda_ops
from nicetpu_torch.kernels import decode3 as td3

from _slot_rows import CASES, records
from test_torch_decode import _image, _placed_records

SRC = Path(td3.__file__).resolve().parent.parent / "csrc" / "slot_assemble_kernels.cu"

KRUN = 1 << 24
MAXD = C.MAX_RUN_DIGITS
BASE = C.PREFIX_RUN_BASE
TILE = 128  # slots a warp takes a step
SCAN_THREADS = 512  # chunks a tile of the per-image pass
LEAD = 5  # where a summary's leading symbols start


def join(a, b):
    return b if b & KRUN else a + b


def join_sat(a, b):
    return b if b & KRUN else (a & KRUN) | min(MAXD, (a & (KRUN - 1)) + b)


def add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def digit_cov(s, k, N):
    dv = s - BASE
    if k == MAXD - 1 and dv > 1:
        dv = 1
    return min(N, (dv << (3 * k)) + (k == 0))


def warp_incl(xs, op):
    """The shuffle scan: at distance d each lane from d on joins the value
    lane - d held before the step."""
    xs = list(xs)
    d = 1
    while d < 32:
        ys = list(xs)
        for lane in range(d, 32):
            xs[lane] = op(ys[lane - d], ys[lane])
        d <<= 1
    return xs


def block_excl(xs, op, ident):
    """The block scan: each warp's inclusive scan, the warps' totals scanned
    by warp 0 (lanes past the warps hold the identity), then each lane's
    warp prefix joined with its lane's exclusive value."""
    nw = len(xs) // 32
    incl = [v for w in range(nw) for v in warp_incl(xs[32 * w : 32 * w + 32], op)]
    tot = warp_incl([incl[32 * w + 31] for w in range(nw)] + [ident] * (32 - nw), op)
    out = []
    for t in range(len(xs)):
        w, lane = divmod(t, 32)
        ex = incl[t - 1] if lane else ident
        out.append(op(tot[w - 1] if w else ident, ex))
    return out, tot[nw - 1]


def chunk_walk(mode, r, base, st, cov, rank, summ=None, out=None, row=0):
    """One warp over one chunk, as `chunk_walk<M>` in the kernel."""
    pos, sym, i12, i34, wb, steps, N = r
    npfx = nlead = nreal = rest = 0
    for t0 in range(0, steps, TILE):
        if mode != "summary" and cov >= N:
            break
        lanes = []
        for lane in range(32):
            i0 = t0 + 4 * lane
            p = [int(pos[base + i0 + u]) if i0 + u < steps else -1 for u in range(4)]
            s = [int(sym[base + i0 + u]) if i0 + u < steps else 0 for u in range(4)]
            e = [0 if not 0 <= p[u] < wb else (KRUN if s[u] < BASE else 1) for u in range(4)]
            agg = 0
            for u in range(4):
                agg = join(agg, e[u])
            lanes.append((i0, s, e, agg))
        incl = warp_incl([ln[3] for ln in lanes], join)
        sums = []
        for lane, (i0, s, e, _) in enumerate(lanes):
            before = join(st, incl[lane - 1] if lane else 0)
            cv, lp = [], 0
            for u in range(4):
                k = before & (KRUN - 1)
                c = 0
                if e[u] == KRUN:
                    c = min(N, 1)
                    lp += 1
                elif e[u] == 1:
                    if before & KRUN:
                        if k < MAXD:
                            c = digit_cov(s[u], k, N)
                    elif mode == "summary":
                        nlead += 1
                        if k < MAXD:
                            summ[LEAD + k] = s[u]
                cv.append(c)
                before = join(before, e[u])
            sums.append((sum(cv), lp, cv))
        st = join(st, incl[31])
        if mode == "summary":
            rest += sum(x[0] for x in sums)
            npfx += sum(x[1] for x in sums)
            continue
        inc = warp_incl([(x[0], x[1]) for x in sums], add)
        for lane, (i0, s, e, _) in enumerate(lanes):
            lsum, lp, cv = sums[lane]
            sc = cov + inc[lane][0] - lsum
            sr = rank + inc[lane][1] - lp
            for u in range(4):
                if e[u] == KRUN and sc < N:
                    if mode == "count":
                        nreal += 1
                    else:
                        at = row + sr
                        out["sym"][at] = s[u]
                        out["i12"][at] = int(i12[base + i0 + u])
                        out["i34"][at] = int(i34[base + i0 + u])
                        out["start"][at] = sc
                sc += cv[u]
                sr += e[u] == KRUN
        cov += inc[31][0]
        rank += inc[31][1]
    if mode == "summary":
        summ[0], summ[1], summ[2], summ[4] = npfx, st & (KRUN - 1), rest, nlead
    return nreal


def model(pos, sym, i12, i34, wbits, n_pixels):
    """The kernels' schedule on numpy records: (sym, i12, i34, start, live,
    ok_cov) as the wrapper returns them."""
    B, nch, steps = pos.shape
    N = n_pixels
    flat = [a.reshape(B, -1) for a in (pos, sym, i12, i34)]
    rows = [(flat[0][b], flat[1][b], flat[2][b], flat[3][b], int(wbits[b]), steps, N) for b in range(B)]
    # 1: a summary a chunk (the slots past nlead stay unwritten: None)
    summ = [[[None] * 16 for _ in range(nch)] for _ in range(B)]
    for b in range(B):
        for c in range(nch):
            chunk_walk("summary", rows[b], c * steps, 0, 0, 0, summ=summ[b][c])
    # 2: one block an image, tiles of SCAN_THREADS chunks
    carry = [[None] * nch for _ in range(B)]
    counts, ok_cov = [], []
    for b in range(B):
        st_carry, acc_carry, real, cross = 0, (0, 0), 0, -1
        for c0 in range(0, nch, SCAN_THREADS):
            cs = range(c0, c0 + SCAN_THREADS)
            sm = [summ[b][c] if c < nch else [0, 0, 0, None, 0] for c in cs]
            st_ex, st_total = block_excl([(KRUN if s[0] > 0 else 0) | min(s[1], MAXD) for s in sm], join_sat, 0)
            d_ins, ccovs = [], []
            for s, ex in zip(sm, st_ex):
                st_in = join_sat(st_carry, ex)
                d_in = st_in & (KRUN - 1) if st_in & KRUN else -1
                ccov = s[2]
                if d_in >= 0:
                    j = 0
                    while j < s[4] and d_in + j < MAXD:
                        ccov += digit_cov(s[LEAD + j], d_in + j, N)
                        j += 1
                d_ins.append(d_in)
                ccovs.append(ccov)
            st_carry = join_sat(st_carry, st_total)
            acc_ex, acc_total = block_excl([(cc, s[0]) for cc, s in zip(ccovs, sm)], add, (0, 0))
            for c, s, d_in, ccov, ex in zip(cs, sm, d_ins, ccovs, acc_ex):
                at = add(acc_carry, ex)
                if c < nch:
                    carry[b][c] = (d_in, at[1], at[0])
                    if at[0] + ccov <= N:
                        real += s[0]
                    elif at[0] < N:
                        assert cross == -1, "two chunks across N"
                        cross = c
            acc_carry = add(acc_carry, acc_total)
        if cross >= 0:
            d_in, rank, cov = carry[b][cross]
            real += chunk_walk("count", rows[b], cross * steps, KRUN | d_in if d_in >= 0 else 0, cov, rank)
        counts.append(real)
        ok_cov.append(acc_carry[0] >= N)
    # 3: the compaction, then live and the fills
    K = max(1, max(counts))
    out = {k: [None] * (B * K) for k in ("sym", "i12", "i34", "start")}
    for b in range(B):
        for c in range(nch):
            d_in, rank, cov = carry[b][c]
            if cov < N:
                chunk_walk("write", rows[b], c * steps, KRUN | d_in if d_in >= 0 else 0, cov, rank, out=out,
                           row=b * K)
    live = [i % K < counts[i // K] for i in range(B * K)]
    for i in range(B * K):
        if not live[i]:
            out["sym"][i], out["i12"][i], out["i34"][i], out["start"][i] = BASE, 0, 0, N
    assert all(v is not None for a in out.values() for v in a), "a compacted column left unwritten"
    as_t = lambda a, dt: torch.tensor(a, dtype=dt).view(B, K)  # noqa: E731
    return (as_t(out["sym"], torch.int32), as_t(out["i12"], torch.int32), as_t(out["i34"], torch.int32),
            as_t(out["start"], torch.int64), as_t(live, torch.bool), torch.tensor(ok_cov))


def _plain(pos, sym, i12, i34, wbits, N):
    return td3.slot_assemble_plain(*(torch.from_numpy(a) for a in (pos, sym, i12, i34, wbits)), N)


def _equal(got, want):
    assert len(got) == len(want) == 6
    for g, w, name in zip(got, want, ("sym", "i12", "i34", "start", "live", "ok_cov")):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype, g.shape, w.shape)
        assert torch.equal(g, w), name


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("B,nch,steps", [(1, 5, 256), (3, 3, 1376), (2, 9, 8), (2, 4, 13)])
def test_kernel_schedule_equals_the_plain_version(case, B, nch, steps):
    """Steps of both rungs, a tile smaller than a warp's step and a
    ragged one (the scalar loads)."""
    rows = records(case, B, nch, steps, seed=B * 1000 + nch * 10 + steps)
    _equal(model(*rows), _plain(*rows))


def test_a_scan_tile_boundary_inside_an_image():
    """More chunks than a tile of the per-image pass: carries across its
    tiles, and a digit chain held across many prefix-free chunks."""
    pos, sym, i12, i34, wbits, N = records("chains", 1, SCAN_THREADS + 70, 8, seed=3)
    sym[0, 100:700] = BASE + 2  # 4,800 digits: chunks without a prefix across the tile boundary
    sym[0, 99, 7] = 0
    _equal(model(pos, sym, i12, i34, wbits, N), _plain(pos, sym, i12, i34, wbits, N))


@pytest.mark.parametrize("lead", [0, 1, 5, 10, 11, 12, 40])
def test_digits_carried_into_a_chunk(lead):
    """A prefix closes chunk 0 after `carried` digits; chunk 1 opens with
    `lead` digits of value 7 (the 11th capped at 1), then a prefix: the
    leading coverage depends on the ordinal carried in."""
    steps = 64
    for carried in (0, 3, 10, 11):
        sym = np.full((1, 2, steps), 1, np.int32)
        sym[0, 0, steps - 1 - carried :] = BASE + 7
        sym[0, 0, steps - 1 - carried] = 2
        sym[0, 1, :lead] = BASE + 7
        pos = np.arange(2 * steps, dtype=np.int32).reshape(1, 2, steps)
        rows = (pos, sym, pos.copy(), pos.copy(), np.array([2 * steps], np.int32), 10**12 // 7)
        _equal(model(*rows), _plain(*rows))


def test_the_chunk_across_n_is_counted_again():
    """N inside a chunk, at a chunk's end and at a chunk's start."""
    pos, sym, i12, i34, wbits, _ = records("walk", 2, 6, 32, seed=11)
    want_full = _plain(pos, sym, i12, i34, wbits, 10**9)
    for N in (1, 31, 32, 33, 64, 95, 150, int(want_full[3][0][want_full[4][0]].max()) + 1):
        _equal(model(pos, sym, i12, i34, wbits, N), _plain(pos, sym, i12, i34, wbits, N))


def test_wrapper_on_cpu_is_the_plain_version_and_matches_jax(monkeypatch):
    """The wrapper hands CPU tensors to the plain version (no launch); its
    starts and coverage gate equal JAX's `assemble_v3` on the decode tests'
    stream: JAX's dst holds each real slot's start, N elsewhere."""
    (pos, sym, i12, i34), wbits, _ = _placed_records(_image(24, 32, seed=2))
    N = 24 * 32
    calls = []
    plain = td3.slot_assemble_plain
    monkeypatch.setattr(td3, "slot_assemble_plain", lambda *a: calls.append(1) or plain(*a))
    before = dict(cuda_ops.LAUNCHES)
    steps = td3._steps(512, 8)
    rec3 = [t.view(1, -1, steps) for t in (pos, sym, i12, i34)]
    got_sym, _, _, start, live, ok_cov = cuda_ops.slot_assemble(*rec3, wbits.to(torch.int32), n_pixels=N)
    assert calls == [1] and cuda_ops.LAUNCHES == before
    z = jnp.zeros(pos.shape, jnp.int32)
    _, jdst, (jcov, _) = jd3.assemble_v3(jnp.asarray(pos.numpy()), jnp.asarray(sym.numpy()), z, z, z, z, N, 32,
                                          jnp.asarray(wbits.numpy()))
    jdst = np.asarray(jdst)[0]
    np.testing.assert_array_equal(start[live].numpy(), jdst[jdst < N])
    np.testing.assert_array_equal(ok_cov.numpy(), np.asarray(jcov))
    assert bool(ok_cov.all()) and bool((got_sym[live] < BASE).all()) and int(live.sum()) > 0


def test_wrapper_refuses_bad_inputs():
    pos, sym, i12, i34, wbits, N = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                    for a in records("walk", 2, 2, 8))
    with pytest.raises(TypeError):
        cuda_ops.slot_assemble(pos.to(torch.int64), sym, i12, i34, wbits, n_pixels=N)
    with pytest.raises(ValueError):
        cuda_ops.slot_assemble(pos[:, :1], sym, i12, i34, wbits, n_pixels=N)
    with pytest.raises(ValueError):
        cuda_ops.slot_assemble(pos.view(2, -1), sym, i12, i34, wbits, n_pixels=N)
    with pytest.raises(ValueError):
        cuda_ops.slot_assemble(pos, sym, i12, i34, wbits[:1], n_pixels=N)


def test_the_scratch_layout_is_the_kernels():
    """The wrapper's summary and carry sizes, and the model's constants, are
    the kernel source's."""
    src = SRC.read_text()

    def const(name):
        value = re.search(rf"constexpr int {name} = ([^;/]+);", src).group(1).split("<<")
        return int(value[0]) << int(value[1]) if len(value) == 2 else int(value[0])

    assert const("kSumInts") == cuda_ops.SLOT_SUMMARY_INTS == 16
    assert const("kCarryInts") == cuda_ops.SLOT_CARRY_INTS
    assert const("kLead") == LEAD and const("kTileSlots") == TILE and const("kScanThreads") == SCAN_THREADS
    assert const("kRunBase") == BASE and const("kMaxDigits") == MAXD
    assert const("kRun") == KRUN
