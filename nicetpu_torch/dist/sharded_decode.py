"""Sharded `.nice` decode over `torch.distributed` ranks.

Counterpart of `nicetpu/dist/sharded_decode.py`, in two shardings:

* **Single raster** (`decode_sharded`): one bitstream decoded across the
  ranks.  The speculative chunk walk is sharded by chunk ranges: each rank
  holds only its slice of the payload words plus the walk's lookahead and
  walks its chunks with every position relative to the slice's first bit
  (`shard_walk`), so that the kernel's int32 positions hold a shard of any
  payload, 2**31 bits or more included; between rounds each rank's last
  exit moves forward to the next rank (`Comm.ppermute`, in int64 global
  positions), and the gates check the shard boundary the same way
  (`walk_gates`).  Slot assembly uses local cumsums and all-gathered per-shard totals
  for the global offsets (digit count, coverage) and a running maximum that
  carries across shards for the digit -> pixel attachment.  The records of
  real pixels are all-gathered and each rank keeps its own row block; the
  reconstruction then runs as a carry pipeline: rank d receives the four
  rows above its block from rank d - 1, runs the reconstruction kernel once
  with that carry (`prev4`), and sends its own last four rows on.  (JAX's
  masked loop computes every block on every device; the result is the
  same.)  The blocks are then gathered (`gather_raster`): on every rank
  (`decode_sharded`), or on rank 0 only (`multihost.decode_multihost` and
  `ShardGroup`).

* **Batch** (`decode_batch_sharded`): each rank decodes its share of a
  same-shape batch with `decode3.decode_batch_v3` and its ladder; the
  arrays are gathered in order.  No collectives run inside the decode.

One rank's part is `decode_rank`: `shardable`, then `decode_block` (the
device half), or the counted host route.  Its stages are spans
"dist.<stage>" (`profiling.StageSpans`: decode_tables, walk, assembly,
records_all_gather, place, carry_wait, recon, then gather_decoded), timed
without a device sync.

Nothing falls back quietly: a raster whose gates fail, or whose geometry
cannot be split (H % n, fewer than 4 rows a rank, W < MIN_WIDTH, a shard of
more than `decode3.MAX_DEVICE_BITS` bits), is decoded
by `hostref.decode_native` and counted in stats["fallbacks"].  The default
walk configuration is the ladder's robust rung (`LADDER[-1]`, 4096-bit
chunks), not the JAX module's 2048-bit `CHUNK_BITS` alias.  Positions,
digit counts and coverage sums run in int64 (the JAX module's int32 cannot
hold a payload of 2**31 bits or more); the records stay int32.
"""

from __future__ import annotations

import numpy as np
import torch

from nicetpu_torch.config import resolve_device
from nicetpu_torch.dist.comm import Comm, RankCall
from nicetpu_torch.dist.sharded import splits
from nicetpu_torch.format import constants as C
from nicetpu_torch.format import headers
from nicetpu_torch.format.huffman import validate_flat_lengths
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import cuda_ops, decode3, recon
from nicetpu_torch.kernels.geometry import Geometry

SHARD_ALIGN = 8  # chunks a rank rounds up to: the JAX walk's block on its jnp path


def shard_geometry(wbits: int, n: int, cfg: decode3.WalkCfg) -> tuple[int, int]:
    """(nlc, steps): chunks a rank and the step budget for a payload of
    wbits bits over n ranks, as `build_sharded_decode` computes them on the
    JAX package's CPU mesh, so that both packages walk the same slices."""
    nch = max(1, -(-wbits // cfg.chunk_bits))
    nlc = -(-nch // n)
    nlc = -(-nlc // SHARD_ALIGN) * SHARD_ALIGN
    return nlc, decode3._steps(cfg.chunk_bits, cfg.steps_div)


def shard_words(payload: bytes, rank: int, nlc: int, chunk_bits: int) -> np.ndarray:
    """A rank's slice of the payload words: its nlc chunks plus the walk's
    lookahead, zeros past the payload; (nlc * chunk_bits/32 + wrows,) uint32."""
    wpc = chunk_bits // 32
    n_words = nlc * wpc + decode3._wrows(chunk_bits)
    lo = rank * nlc * wpc
    src = np.frombuffer(payload[4 * lo : 4 * (lo + n_words)], dtype=np.uint8)
    out = np.zeros(4 * n_words, dtype=np.uint8)
    out[: src.size] = src
    return out.view(">u4").astype(np.uint32)


def shard_walk(words, entries, tables, wbits: int, *, base: int, span: int, chunk_bits: int,
               steps: int, records: bool = True):
    """One walk round over a shard's slice of the words, its positions
    relative to the slice's first bit `base`: the walk kernel's int32
    positions stay below `span` plus one pixel group, however long the
    payload.

    entries (1, nlc) int64 global bit positions (at least base - rounds *
    chunk_bits: an entry moves back by at most one chunk a round); wbits the
    payload's global bit count; span = nlc * chunk_bits, the slice's bound.
    The kernel gets the total relative to base, clamped to [-2**30, span]:
    a chunk freezes at min(its bound, wbits), and no entry lies below
    -2**30.  Returns (records, exits): the four (1, nlc, steps) int32 record
    arrays, pos relative to base (None each without records), and the exits
    (1, nlc) int64 global."""
    aff, dD, inc, pfx = tables
    rel_total = min(max(wbits - base, -(2**30)), span)
    wb = torch.tensor([rel_total], dtype=torch.int32, device=words.device)
    e = (entries - base).to(torch.int32).contiguous()
    *recs, ex = decode3.walk(words, e, aff, dD, inc, pfx, wb, chunk_bits=chunk_bits, steps=steps,
                             records=records)
    return recs, ex.to(torch.int64) + base


def walk_gates(e, ex2, prev_exit, wbits: int, *, base: int, chunk_bits: int, first: bool):
    """The walk's gates on one shard, in int64 global positions, as a (2,)
    bool tensor [consistency, crossing]: every final exit still inside the
    payload equals the next chunk's entry and the previous shard's last exit
    equals this shard's first entry (not on the first shard, whose first
    entry is the bit-0 anchor); every walked chunk crossed its bound.  e,
    ex2 (nlc,) int64; prev_exit () int64."""
    starts = base + torch.arange(e.shape[0], dtype=torch.int64, device=e.device) * chunk_bits
    ok_in = ((ex2[:-1] == e[1:]) | (ex2[:-1] >= wbits)).all()
    first_ok = (prev_exit == e[0]) | (prev_exit >= wbits) | first
    crossed = ex2 >= torch.clamp(starts + chunk_bits, max=wbits)
    return torch.stack([ok_in & first_ok, (crossed | (e >= wbits)).all()])


def _walk_shard(words, wbits: int, tables, comm: Comm, *, nlc: int, cfg, steps: int):
    """The speculative rounds over this rank's chunks, entries moving forward
    across the shard boundary between rounds.  Returns the final round's
    records (pos relative to the shard's first bit), its entries e and exits
    (int64 global), the previous rank's final exit and the shard's first
    bit."""
    base = comm.rank * nlc * cfg.chunk_bits
    kw = dict(base=base, span=nlc * cfg.chunk_bits, chunk_bits=cfg.chunk_bits, steps=steps)
    # round 1 from the chunk starts; rank 0's first entry is the anchor, bit 0
    # (ppermute gives rank 0 zeros)
    e = base + torch.arange(nlc, dtype=torch.int64, device=words.device)[None] * cfg.chunk_bits
    for _ in range(cfg.rounds - 1):
        ex = shard_walk(words, e, tables, wbits, records=False, **kw)[1]
        e = torch.cat([comm.ppermute(ex[:, -1:]), ex[:, :-1]], dim=1)
    recs, ex2 = shard_walk(words, e, tables, wbits, **kw)
    prev_exit = comm.ppermute(ex2[:, -1:])[0, 0]
    return recs, e[0], ex2[0], prev_exit, base


def shardable(data: bytes, n: int, cfg: decode3.WalkCfg) -> bool:
    """Whether the raster of `data` splits over n ranks (`sharded.splits`),
    each shard within what the walk can hold."""
    W, H, _ = headers.parse_file_header(data)
    nlc, _ = shard_geometry(decode3.payload_bits(data), n, cfg)
    return splits(H, W, n) and nlc * cfg.chunk_bits <= decode3.MAX_DEVICE_BITS


def decode_block(call: RankCall, data: bytes, cfg: decode3.WalkCfg):
    """This rank's (3, n_local) uint8 row block, or None on every rank where
    the gates failed.  Global quantities (positions, digit and coverage
    counts) are int64; each slot-space temporary is dropped once the next
    step has consumed it, and only the real pixels' slots reach the value
    join and the records, so that a 16384x16384 raster's shards fit four
    ranks on one card.  The call's stats, where given, receive "gates",
    "real_slots" and accumulate "records_bytes" (the bytes of the records
    all-gather that this rank receives), "recon_chains" (the (image,
    channel) chains it reconstructs) and "recon_cluster_chains" (those that
    ran on a thread-block cluster: 0 on the CPU)."""
    comm, device, stages, stats = call.comm, call.device, call.stages, call.stats
    W, H, _ = headers.parse_file_header(data)
    n, rank = comm.size, comm.rank
    N = H * W
    n_local = (H // n) * W
    with stages.stage("decode_tables"):
        flat_lengths = headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :])
        validate_flat_lengths(flat_lengths)
        lens = torch.from_numpy(flat_lengths.astype(np.int64)[None]).to(device)
        _, _, _, pfx, sym_tbl, _, _, aff, dD, inc = decode3.prepare_tables_v3(lens, walk=True)
        wbits = decode3.payload_bits(data)
        nlc, steps = shard_geometry(wbits, n, cfg)
        payload = memoryview(data)[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(data) - 4]
        words = torch.from_numpy(shard_words(payload, rank, nlc, cfg.chunk_bits).view(np.int32))
        words = words[None].to(device)

    with stages.stage("walk"):
        recs, e, ex2, prev_exit, base = _walk_shard(
            words, wbits, (aff, dD, inc, pfx.contiguous()), comm, nlc=nlc, cfg=cfg, steps=steps
        )
        del words
        ok_walk = walk_gates(e, ex2, prev_exit, wbits, base=base, chunk_bits=cfg.chunk_bits,
                             first=rank == 0)

    with stages.stage("assembly"):
        # slot-space assembly with cross-shard offsets (int64)
        pos, sym, i12, i34 = (r.reshape(-1) for r in recs)
        del recs
        valid = (pos >= 0) & (pos < min(max(wbits - base, -1), nlc * cfg.chunk_bits))
        del pos
        is_pfx = valid & (sym < C.PREFIX_RUN_BASE)
        is_dig = valid & (sym >= C.PREFIX_RUN_BASE)
        del valid
        cd = torch.cumsum(is_dig, dim=0, dtype=torch.int64)
        m_loc = torch.where(is_pfx, cd, -1).max()
        # one all-gather: [consistency, crossing, digits, last prefix's digit count]
        g1 = comm.all_gather(torch.cat([ok_walk.to(torch.int64), torch.stack([cd[-1], m_loc])]))
        offs_cd = torch.cumsum(g1[:, 2], dim=0) - g1[:, 2]
        allm = torch.where(g1[:, 3] >= 0, g1[:, 3] + offs_cd, -1)
        prevm = int(allm[:rank].max()) if rank > 0 else -1
        cd += offs_cd[rank]
        cd_base = torch.cummax(torch.where(is_pfx, cd, -1), dim=0).values.clamp_(min=prevm)
        dig_ok = is_dig & (cd_base >= 0)
        kk = cd.sub_(cd_base).sub_(1)  # digits since the last prefix, minus one
        del cd, cd_base, is_dig
        dig_ok &= (kk >= 0) & (kk < C.MAX_RUN_DIGITS)
        first_digit = kk == 0
        shift = kk.clamp_(0, C.MAX_RUN_DIGITS - 1)
        dv = (sym - C.PREFIX_RUN_BASE).to(torch.int64)
        dv.masked_fill_((shift == C.MAX_RUN_DIGITS - 1) & (dv > 1), 1)
        cov = dv.bitwise_left_shift_(shift.mul_(3)).add_(first_digit)
        del kk, shift, first_digit
        cov.masked_fill_(~dig_ok, 0).add_(is_pfx).clamp_(max=N)
        del dig_ok
        start = torch.cumsum(cov, dim=0)
        g2 = comm.all_gather(start[-1:])[:, 0]
        start.sub_(cov).add_(g2[:rank].sum())  # the coverage of the ranks before
        del cov
        keep = torch.nonzero(is_pfx & (start < N)).reshape(-1)  # the real pixels' slots
        del is_pfx
        sym, i12, i34, start = sym[keep], i12[keep], i34[keep], start[keep]
        del keep
        if stats is not None:
            stats["real_slots"] = sym.numel()

        # payload symbols and packed placement records of the real slots
        bins = decode3._payload_bins(sym[None], i12[None], i34[None])
        del i12, i34
        if sym.numel():
            syms = cuda_ops.value_join(bins, sym_tbl.contiguous())[:, 0]
        else:  # a shard of runs only: no real slot
            syms = bins[:, 0]
        del bins
        rec = torch.empty_like(sym)
        dst = torch.empty_like(start)
        geom = Geometry.uniform(W, N, 1, device)  # the raster's, for the records' maps
        for a in range(0, sym.numel(), decode3.RECORD_BLOCK):  # bounds slot_records' temporaries
            cut = slice(a, a + decode3.RECORD_BLOCK)
            real = torch.ones_like(sym[cut], dtype=torch.bool)
            rec[cut], dst[cut] = decode3.slot_records(real, sym[cut], *syms[:, cut], start[cut], real, geom=geom)
        ok_ref = ~((sym == C.PREFIX_BACK_REF) & (syms[0] >= C.NUM_BACK_REF)).any()
        del sym, syms, start
        g3 = comm.all_gather(torch.stack([ok_ref.to(torch.int64), torch.tensor(rec.numel(), device=device)]))
        gates = {"consistency": bool(g1[:, 0].all()), "crossing": bool(g1[:, 1].all()),
                 "coverage": int(g2.sum()) >= N, "backref": bool(g3[:, 0].all())}
    if stats is not None:
        stats["gates"] = gates
    if not all(gates.values()):
        return None

    with stages.stage("records_all_gather"):
        # the records of real pixels, all-gathered; this rank keeps its rows
        k_max = max(1, int(g3[:, 1].max()))
        mine = torch.full((2, k_max), N, dtype=torch.int32, device=device)
        mine[0, : rec.numel()] = rec
        mine[1, : rec.numel()] = dst.to(torch.int32)
        del rec, dst
        allrec = comm.all_gather(mine)
        del mine
        call.count("records_bytes", allrec.numel() * allrec.element_size())
    with stages.stage("place"):
        # each rank's records lie in pixel order (padding N last): this rank's
        # rows are one run of each
        lo = rank * n_local
        bounds = torch.tensor([[lo, lo + n_local]], dtype=torch.int32, device=device).expand(n, 2)
        cuts = torch.searchsorted(allrec[:, 1].contiguous(), bounds.contiguous()).tolist()
        rec_o = torch.cat([allrec[r, 0, a:b] for r, (a, b) in enumerate(cuts)])
        dst_o = torch.cat([allrec[r, 1, a:b] for r, (a, b) in enumerate(cuts)]) - lo
        del allrec
        form, delta, refoff = decode3.place_and_unpack(rec_o[None], dst_o[None],
                                                        geom=Geometry.uniform(W, n_local, 1, device))
        del rec_o, dst_o

    # the carry pipeline: the four rows above from rank d - 1, one kernel
    # run, the last four rows on to rank d + 1
    with stages.stage("carry_wait"):
        carry = comm.recv_prev(torch.zeros(1, 3, 4 * W, dtype=torch.int32, device=device))
    with stages.stage("recon"):
        out, tail = recon.reconstruct_rows(form, delta, refoff, width=W, prev4=carry.contiguous(),
                                           stats=stats)
        comm.send_next(tail)
    return out[0].to(torch.uint8)


def decode_rank(call: RankCall, data: bytes, cfg: decode3.WalkCfg) -> torch.Tensor | None:
    """This rank's decoded (3, n_local) block of `data`, or None on every
    rank where the host decodes the raster instead: it does not split over
    the ranks, a shard is longer than the walk holds, or the gates failed.
    That route is counted in "fallbacks", present at 0 otherwise."""
    block = decode_block(call, data, cfg) if shardable(data, call.comm.size, cfg) else None
    call.count("fallbacks", int(block is None))
    return block


def gather_raster(call: RankCall, block: torch.Tensor, height: int, width: int, *,
                  everywhere: bool = False) -> np.ndarray | None:
    """The decoded blocks as an (H, W, 3) host raster: on every rank
    (everywhere=True, an all-gather) or on rank 0 only (None elsewhere)."""
    with call.stages.stage("gather_decoded"):
        blocks = call.comm.all_gather(block) if everywhere else call.comm.gather_root(block)
        if blocks is None:
            return None
        return blocks.permute(1, 0, 2).reshape(3, height, width).permute(1, 2, 0).cpu().numpy()


def decode_raster(call: RankCall, data: bytes, cfg: decode3.WalkCfg | None = None, *,
                  everywhere: bool) -> np.ndarray | None:
    """Decode one `.nice` raster that every rank holds across the ranks:
    the (H, W, 3) uint8 raster on every rank (everywhere=True) or on rank 0
    only (None elsewhere).  cfg defaults to the robust rung."""
    W, H, channels = headers.parse_file_header(data)
    if channels != 3:
        raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
    block = decode_rank(call, data, cfg or decode3.LADDER[-1])
    if block is None:
        return oracle.decode_native(data) if everywhere or call.root else None
    return gather_raster(call, block, H, W, everywhere=everywhere)


def decode_sharded(data: bytes, *, device="cuda", group=None, cfg: decode3.WalkCfg | None = None,
                   stats: dict | None = None) -> np.ndarray:
    """Decode one `.nice` stream across the ranks of `group` (the default
    group if None): call it on every rank with the same bytes; every rank
    returns the (H, W, 3) uint8 raster.

    device: "cuda" (the rank's current CUDA device; raises without CUDA) or
    "cpu" (the kernels' plain versions).  cfg: the walk configuration
    (default the robust rung `decode3.LADDER[-1]`).  stats: optional dict;
    receives "fallbacks" (1 when the host decoder served the raster),
    "gates" (the four gates over all ranks, where the walk ran),
    "real_slots" (this rank's slots of real pixels, 0 on a shard of runs
    only, which launches no value join), "records_bytes", "recon_chains",
    "recon_cluster_chains" and "stages" (this rank's host seconds per
    stage, the spans "dist.<stage>"; nothing waits for the device)."""
    return decode_raster(RankCall(Comm(group), resolve_device(device), stats), data, cfg, everywhere=True)


def decode_batch_sharded(datas: list[bytes], *, device="cuda", group=None,
                         stats: dict | None = None) -> list[np.ndarray]:
    """Decode a same-shape batch, len(datas) / n images a rank (call it on
    every rank with the same list); every rank returns all the arrays, in
    order.  Each rank runs `decode3.decode_batch_v3` (the retry ladder, then
    the host decoder); stats receives the sums over the ranks of "retries"
    and "fallbacks"."""
    comm = Comm(group)
    n = comm.size
    if len(datas) % n:
        raise ValueError(f"batch size must be a multiple of {n} ranks")
    k = len(datas) // n
    dev = resolve_device(device)
    sub: dict = {}
    arrs = decode3.decode_batch_v3(datas[comm.rank * k : (comm.rank + 1) * k], device=dev, stats=sub)
    gathered = comm.all_gather(torch.from_numpy(np.stack(arrs)))
    counts = comm.psum(torch.tensor([sub.get("retries", 0), sub.get("fallbacks", 0)]))
    if stats is not None:
        stats["retries"] = stats.get("retries", 0) + int(counts[0])
        stats["fallbacks"] = stats.get("fallbacks", 0) + int(counts[1])
    return [a.numpy() for a in gathered.reshape(n * k, *gathered.shape[2:])]
