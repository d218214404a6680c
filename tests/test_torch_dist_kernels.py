"""The shard-relative walk and the reconstruction's four-row carry, on the
CPU: the re-based shard walk held against JAX's `walk_ref(chunk0=,
bit_base=)` with the positions shifted, the carry against
`decode_dev.reconstruct_rows(prev4=)`, and the port's shard geometry and
word slices against the JAX sharded decode's."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicetpu.hostref import oracle
from nicetpu.kernels import decode3 as jd3
from nicetpu.kernels import decode_dev as jdd
from nicetpu_torch.dist import sharded_decode as tsd
from nicetpu_torch.kernels import decode3 as td3
from nicetpu_torch.kernels import recon

from test_torch_decode import _eq, _image, _payload_words, _recon_inputs, _t, _walk_args

N_DEV = 4


def _jax_slices(payload_words: np.ndarray, n: int, nlc: int, chunk_bits: int) -> np.ndarray:
    """The words each device gets in the JAX `decode_sharded` (:271-279)."""
    wpc = chunk_bits // 32
    wrows = jd3._wrows(chunk_bits)
    flat = np.zeros(n * nlc * wpc + wrows, dtype=np.uint32)
    flat[: len(payload_words)] = payload_words
    return np.stack([flat[d * nlc * wpc : d * nlc * wpc + nlc * wpc + wrows] for d in range(n)])


@pytest.mark.parametrize("chunk_bits", [512, 2048])
def test_shard_geometry_and_slices_match_jax(chunk_bits):
    data = oracle.encode_native(_image(64, 96, seed=1))
    _, words, wbits = _payload_words(data, 0)
    payload = data[-4 - wbits // 8 : -4]
    cfg = td3.WalkCfg(chunk_bits, 8, 3, 3)
    nlc, steps = tsd.shard_geometry(wbits, N_DEV, cfg)
    # build_sharded_decode's geometry on the CPU mesh (the jnp walk pads to 8)
    nch = -(-wbits // chunk_bits)
    align = jd3._cpb(jd3._rows_for(chunk_bits))
    assert nlc == -(-(-(-nch // N_DEV)) // align) * align
    assert steps == jd3._steps(chunk_bits, 3) and steps % td3.WALK_TILE == 0
    want = _jax_slices(words, N_DEV, nlc, chunk_bits)
    for d in range(N_DEV):
        np.testing.assert_array_equal(tsd.shard_words(payload, d, nlc, chunk_bits), want[d])


def _shifted(want_pos, base):
    """JAX's global record positions relative to a shard's first bit (-1,
    a frozen step, stays -1)."""
    w = np.asarray(want_pos)
    return np.where(w == -1, -1, w - base)


@pytest.mark.parametrize("chunk_bits", [512, 1024])
def test_shard_local_walks_match_walk_ref(chunk_bits):
    """Each shard's walk over its slice, re-based to the slice's first bit
    (`shard_walk`), equals JAX's walk_ref with chunk0/bit_base with the
    positions shifted, for two rounds whose entries cross the shard
    boundaries; together the shards give the unsharded walk."""
    data = oracle.encode_native(_image(64, 96, seed=2))
    lengths, words, wbits = _payload_words(data, 0)
    cfg = td3.WalkCfg(chunk_bits, 8, 3, 3)
    nlc, steps = tsd.shard_geometry(wbits, N_DEV, cfg)
    slices = _jax_slices(words, N_DEV, nlc, chunk_bits)
    jargs, targs = _walk_args(lengths, slices[0], wbits)
    _, aff, dD, inc, pfx, wb = jargs
    tables = targs[1:5]
    jwalk = jax.jit(partial(jd3.walk_ref, chunk_bits=chunk_bits, steps=steps, maxl=jd3.FUSED_MAXL))
    full_words = _t(np.concatenate([words, np.zeros(nlc * N_DEV * chunk_bits // 32 + 80, np.uint32)])
                    .view(np.int32)[None])
    e = np.arange(N_DEV * nlc, dtype=np.int32) * chunk_bits
    for _ in range(2):
        exits = []
        for d in range(N_DEV):
            c0 = d * nlc
            base = c0 * chunk_bits
            ed = e[c0 : c0 + nlc]
            want = jwalk(jnp.asarray(slices[d].view(np.int32)), jnp.asarray(ed), aff, dD, inc, pfx, wb,
                         chunk0=jnp.int32(c0), bit_base=jnp.int32(base))
            (pos, *recs), ex = tsd.shard_walk(_t(slices[d].view(np.int32)[None]),
                                              _t(ed[None].astype(np.int64)), tables, wbits, base=base,
                                              span=nlc * chunk_bits, chunk_bits=chunk_bits, steps=steps)
            _eq(pos[0], _shifted(want[0], base))
            for g, w in zip(recs, want[1:4]):
                _eq(g[0], w)
            assert ex.dtype == torch.int64
            _eq(ex[0], want[4])
            exits.append(np.asarray(want[4]))
        whole = td3.walk_plain(full_words, _t(e[None]), *targs[1:], chunk_bits=chunk_bits, steps=steps)
        _eq(whole[4][0], np.concatenate(exits))
        ex = np.concatenate(exits)
        e = np.concatenate([[0], ex[:-1]]).astype(np.int32)


def test_walk_entry_before_the_slice_stays_in_bounds():
    """An entry before a shard's slice (a previous shard's chunk that failed
    to cross) is a negative relative position: the walk reads the slice's
    first word, runs, and its first record sits at that entry; the gates,
    not the records, decide such a raster.  The wrapper on the CPU is the
    plain version."""
    data = oracle.encode_native(_image(48, 64, seed=3))
    lengths, words, wbits = _payload_words(data, 80)
    _, targs = _walk_args(lengths, words, wbits)
    chunk_bits = 512
    c0 = 4
    base = c0 * chunk_bits
    part = _t(words[c0 * chunk_bits // 32 :].view(np.int32)[None])
    e = (np.arange(3, dtype=np.int64) + c0) * chunk_bits
    e[0] -= 100
    (pos, *_), ex = tsd.shard_walk(part, _t(e[None]), targs[1:5], wbits, base=base,
                                   span=3 * chunk_bits, chunk_bits=chunk_bits, steps=64)
    assert int(pos[0, 0, 0]) == -100
    assert (ex[0].numpy() >= e).all()
    rel = _t((e - base).astype(np.int32)[None])
    wb = _t(np.array([wbits - base], np.int32))
    got = td3.walk(part, rel, *targs[1:5], wb, chunk_bits=chunk_bits, steps=64)
    want = td3.walk_plain(part, rel, *targs[1:5], wb, chunk_bits=chunk_bits, steps=64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[0][0, 0, 0]) == -100


def _carry(B, W, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, 3, 4 * W)).astype(np.int32)


@pytest.mark.parametrize("B,H,W", [(2, 6, 20), (2, 5, 64), (1, 3, 8)])
def test_reconstruct_rows_with_carry_matches_jax(B, H, W):
    form, delta, refoff = _recon_inputs(B, H, W, seed=W + 1)
    prev4 = _carry(B, W, seed=W)
    N = H * W
    jrecon = jax.jit(jax.vmap(partial(jdd.reconstruct_rows, n_pixels=N, width=W,
                                      segs=jdd._pick_segs(W))))
    want_out, want_tail = jrecon(jnp.asarray(form), jnp.asarray(delta), jnp.asarray(refoff),
                                 prev4=jnp.asarray(prev4))
    out, tail = recon.reconstruct_rows(_t(form), _t(delta), _t(refoff), width=W, prev4=_t(prev4))
    _eq(out, want_out)
    _eq(tail, want_tail)


@pytest.mark.parametrize("W,rows", [(20, (4, 4, 4)), (9, (5, 3, 4, 2)), (4, (1, 7))])
def test_blocks_chained_through_the_carry_equal_the_unsplit_chain(W, rows):
    """Row blocks reconstructed one after another, each from the previous
    block's tail (the first from zeros), give the unsplit plain chain."""
    B, H = 2, sum(rows)
    form, delta, refoff = (_t(a) for a in _recon_inputs(B, H, W, seed=7 * W))
    whole = recon.reconstruct_rows(form, delta, refoff, width=W)
    carry = torch.zeros(B, 3, 4 * W, dtype=torch.int32)
    outs, r0 = [], 0
    for h in rows:
        cut = slice(r0 * W, (r0 + h) * W)
        out, carry = recon.reconstruct_rows(form[:, cut].contiguous(), delta[:, :, cut].contiguous(),
                                            refoff[:, cut].contiguous(), width=W, prev4=carry)
        outs.append(out)
        r0 += h
    assert torch.equal(torch.cat(outs, dim=2), whole)
    assert torch.equal(carry, torch.cat([torch.zeros(B, 3, 4 * W, dtype=torch.int32), whole], 2)[..., -4 * W:])


def test_reconstruct_rows_checks_the_carry():
    form, delta, refoff = (_t(a) for a in _recon_inputs(1, 4, 8, seed=0))
    for bad in (torch.zeros(1, 3, 31, dtype=torch.int32), torch.zeros(1, 3, 32, dtype=torch.int64)):
        with pytest.raises((ValueError, TypeError)):
            recon.reconstruct_rows(form, delta, refoff, width=8, prev4=bad)
