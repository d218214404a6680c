"""On-device Huffman table construction (all 10 streams, batched), PyTorch.

Counterpart of `nicetpu/kernels/huffman_dev.py`: from per-image flat
histograms it builds the same code lengths and canonical codes as the host
tables of `nicetpu.format.huffman`, so the payload is byte-identical.

`build_tables_device` is the wrapper: on a CUDA tensor it makes one launch
of the `huffman_tables` kernel (`csrc/huffman_kernels.cu`, through
`cuda_ops.huffman_tables`) and reads nothing back, as JAX's jitted
`build_tables_device` is one device program; on a CPU tensor it runs the
plain version, `build_tables_device_plain`, below.

Merge order (the deterministic replacement for the reference's unspecified
heap order): every live symbol starts as a leaf of length 1; the two minimum
nodes merge until two remain; nodes order by (weight, leaf before internal,
least symbol under the node).  The JAX version finds the minimum with three
masked reductions; here the three fields pack into one int64 key,
weight << 11 | internal << 10 | min_symbol (min_symbol < 343), whose
ordinary minimum is the same node.  In the plain version the 341-step merge
is a Python loop of tensor ops over (B, 10, nodes) lanes, and the
length-limit re-merge runs only when some stream exceeds 31 bits, decided
on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from nicetpu_torch.format import constants as C
from nicetpu_torch.convert import MASK32, to_int32_bits
from nicetpu_torch.kernels import cuda_ops

NSTREAMS = C.NUM_STREAMS
PMAX = max(C.ALPHABET_SIZES)  # 343; nodes: leaves [0, PMAX), internals after
DEAD = torch.iinfo(torch.int64).max

_SIZES = np.asarray(C.ALPHABET_SIZES, dtype=np.int64)
# (10, PMAX) flat bin of each stream lane; dead lanes point at bin 858,
# a zero column the gather appends.
_LANE_BIN = np.where(
    np.arange(PMAX)[None, :] < _SIZES[:, None],
    np.asarray(C.STREAM_BASE)[:, None] + np.arange(PMAX)[None, :],
    C.TOTAL_SYMBOLS,
)
# (858,) lane (s * PMAX + p) of each flat bin
_FLAT_LANE = np.concatenate(
    [s * PMAX + np.arange(C.ALPHABET_SIZES[s]) for s in range(NSTREAMS)]
)


def _counts_to_streams(flat: torch.Tensor) -> torch.Tensor:
    """(B, 858) -> (B, 10, PMAX) with dead lanes zero."""
    padded = torch.nn.functional.pad(flat, (0, 1))
    return padded[:, torch.as_tensor(_LANE_BIN, device=flat.device)]


def _streams_to_flat(per_stream: torch.Tensor) -> torch.Tensor:
    """(B, 10, PMAX) -> (B, 858)."""
    lanes = torch.as_tensor(_FLAT_LANE, device=per_stream.device)
    return per_stream.reshape(per_stream.shape[0], -1)[:, lanes]


def _merge_lengths(cs: torch.Tensor) -> torch.Tensor:
    """Huffman merge for (B, 10, PMAX) int64 per-stream counts.

    Returns (B, 10, PMAX) int64 lengths (>= 1 on live lanes, 0 on dead)."""
    B = cs.shape[0]
    dev = cs.device
    sym = torch.arange(PMAX, device=dev)
    sizes = torch.as_tensor(_SIZES, device=dev)
    live0 = (sym[None, :] < sizes[:, None]).expand(B, NSTREAMS, PMAX)

    leaf_key = torch.where(live0, (cs << 11) | sym, DEAD)
    key = torch.cat([leaf_key, torch.full_like(leaf_key, DEAD)], dim=-1)
    node_of_sym = sym.expand(B, NSTREAMS, PMAX)
    lengths = live0.to(torch.int64)
    # active[it, s]: stream s still merges at step it
    steps = torch.arange(PMAX - 2, device=dev)
    active = (steps[:, None] < (sizes - 2)[None, :])[:, None, :, None]

    for it in range(PMAX - 2):
        act = active[it]
        ia = key.argmin(dim=-1, keepdim=True)
        ka = key.gather(-1, ia)
        rest = key.scatter(-1, ia, DEAD)
        ib = rest.argmin(dim=-1, keepdim=True)
        kb = rest.gather(-1, ib)
        m = PMAX + it  # new internal node id
        merged = (((ka >> 11) + (kb >> 11)) << 11) | 1024 | torch.minimum(ka & 1023, kb & 1023)
        under = ((node_of_sym == ia) | (node_of_sym == ib)) & act
        lengths = lengths + under
        node_of_sym = torch.where(under, m, node_of_sym)
        rest = rest.scatter(-1, ib, DEAD)
        rest[..., m : m + 1] = merged
        key = torch.where(act, rest, key)  # finished streams keep their nodes
    return lengths


def code_lengths_device(counts: torch.Tensor):
    """Huffman code lengths for all streams of a batch of images.

    counts: (B, 858) integer histograms.  Streams whose lengths exceed the
    31-bit header limit get every count clamped up to `clamp_floor(total)`
    and re-merged, as `format.huffman.code_lengths` does.
    Returns (flat_lengths (B, 858) int32, overflow (B,) bool — true only if
    a clamped stream still exceeds 31 bits).
    """
    cs = _counts_to_streams(counts.to(torch.int64))
    lengths = _merge_lengths(cs)
    ovf_stream = (lengths > C.MAX_CODE_LEN).any(dim=-1)  # (B, 10)
    if bool(ovf_stream.any()):
        floor_w = (cs.sum(dim=-1) >> 20) + 1  # format.huffman.clamp_floor
        cs2 = torch.where(ovf_stream[..., None], torch.maximum(cs, floor_w[..., None]), cs)
        lengths = _merge_lengths(cs2)
    overflow = (lengths > C.MAX_CODE_LEN).flatten(1).any(dim=1)
    return _streams_to_flat(lengths).to(torch.int32), overflow


def canonical_codes_device(flat_lengths: torch.Tensor) -> torch.Tensor:
    """Canonical codes, (length asc, symbol asc) counting up from 0.

    flat_lengths: (B, 858) integer (>= 1 for live symbols).  Returns
    (B, 858) int32 bit patterns of the uint32 codes (valid in the low
    `length` bits).  The first-code scan runs in int64, so lengths 30 and
    31 cannot overflow; the codes keep their low 32 bits, as JAX's do.
    """
    ls = _counts_to_streams(flat_lengths.to(torch.int64))  # (B, 10, PMAX)
    L = C.MAX_CODE_LEN + 1
    lens = torch.arange(1, L + 1, device=ls.device)
    oh = (ls[..., None] == lens).to(torch.int64)  # (B, 10, PMAX, L)
    cnt = oh.sum(dim=2)  # (B, 10, L) symbols per length
    # first[l] = (first[l-1] + cnt[l-1]) * 2  ==  sum_{j<l} cnt[j] << (l - j)
    d = lens[:, None] - lens[None, :]
    pow2 = torch.where(d > 0, torch.ones_like(d) << d.clamp(min=0), 0)  # (L, L)
    firsts = (cnt[..., None, :] * pow2).sum(dim=-1)  # (B, 10, L)
    rank = torch.cumsum(oh, dim=2) - oh  # rank among same-length symbols
    own = (rank * oh).sum(dim=-1)
    first_own = (firsts[:, :, None, :] * oh).sum(dim=-1)
    codes = torch.where(ls > 0, (first_own + own) & MASK32, 0)
    return to_int32_bits(_streams_to_flat(codes))


def build_tables_device_plain(counts: torch.Tensor):
    """The plain version of `build_tables_device`, in tensor ops."""
    lengths, overflow = code_lengths_device(counts)
    return lengths, canonical_codes_device(lengths), overflow


def build_tables_device(counts: torch.Tensor):
    """(B, 858) int32 or int64 histograms -> (lengths (B, 858) int32, codes
    (B, 858) int32 bit patterns, overflow (B,) bool).  Equal to
    format.huffman's tables whenever overflow is False.  One kernel launch on
    a CUDA tensor, with no host read; the plain version on a CPU tensor."""
    return cuda_ops.huffman_tables(counts)
