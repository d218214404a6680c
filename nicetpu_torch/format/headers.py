"""Container and stream-header serialization (host-side, trivial sizes).

The port's own copy of `nicetpu/format/headers.py` (same functions, same
bytes); `tests/test_torch_copies.py` holds the two equal.

File header: magic "nice", width u32 BE, height u32 BE, channels u8
(ref code.rs:72-84 / 469-482).  Stream headers: per stream a 5-bit max_aob
followed by alphabet_size x 7-bit code lengths, bit-packed MSB-first with no
alignment between streams (ref hfe.rs:97-103 / 173-204; SURVEY A.2).  The ten
headers always total exactly 757 bytes.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from nicetpu_torch.format import constants as C


def pack_file_header(width: int, height: int, channels: int = 3) -> bytes:
    return C.MAGIC + struct.pack(">IIB", width, height, channels)


def parse_file_header(data: bytes) -> tuple[int, int, int]:
    """Returns (width, height, channels).  Magic is not validated, matching
    the reference decoder (ref code.rs:469; SURVEY A.8.4)."""
    if len(data) < C.FILE_HEADER_BYTES:
        raise ValueError("truncated .nice header")
    width, height, channels = struct.unpack(">IIB", data[4:13])
    return width, height, channels


@functools.lru_cache(maxsize=None)
def _stream_header_fields() -> tuple[np.ndarray, np.ndarray]:
    """The ten headers' fields in order, as (each field's index into the
    858 code lengths followed by the ten streams' maxima, (fields, 7) bool:
    the bits each field writes of a 7-bit value, MSB first)."""
    idx, width = [], []
    for s in range(C.NUM_STREAMS):
        idx.append(C.TOTAL_SYMBOLS + s)
        width.append(C.MAX_AOB_FIELD_BITS)
        idx.extend(range(C.STREAM_BASE[s], C.STREAM_BASE[s] + C.ALPHABET_SIZES[s]))
        width.extend([C.AOB_FIELD_BITS] * C.ALPHABET_SIZES[s])
    keep = np.arange(C.AOB_FIELD_BITS)[None, :] >= C.AOB_FIELD_BITS - np.array(width)[:, None]
    return np.array(idx), keep


_FIELD_SHIFTS = np.arange(C.AOB_FIELD_BITS - 1, -1, -1)


def pack_stream_headers(flat_lengths: np.ndarray) -> bytes:
    """Serialize all ten stream headers from flat (858,) code lengths: each
    stream's max_aob, then its lengths, bit-packed MSB-first."""
    lens = np.asarray(flat_lengths).astype(np.int64)
    idx, keep = _stream_header_fields()
    vals = np.concatenate([lens, np.maximum.reduceat(lens, C.STREAM_BASE)])[idx]
    out = np.packbits(((vals[:, None] >> _FIELD_SHIFTS) & 1)[keep].astype(np.uint8)).tobytes()
    assert len(out) == C.STREAM_HEADERS_BYTES
    return out


def parse_stream_headers(data: bytes) -> np.ndarray:
    """Parse ten stream headers -> flat (858,) uint8 code lengths.

    `data` must start at the first stream header (file offset 13).
    """
    if len(data) < C.STREAM_HEADERS_BYTES:
        raise ValueError("truncated stream headers")
    # Unpack the fixed 6056-bit region to a bit array, then gather fields.
    raw = np.frombuffer(data[: C.STREAM_HEADERS_BYTES], dtype=np.uint8)
    bits = np.unpackbits(raw)  # MSB-first
    flat_lengths = np.zeros(C.TOTAL_SYMBOLS, dtype=np.uint8)
    pos = 0
    for s in range(C.NUM_STREAMS):
        pos += C.MAX_AOB_FIELD_BITS  # max_aob is redundant given the lengths
        size = C.ALPHABET_SIZES[s]
        field = bits[pos : pos + size * C.AOB_FIELD_BITS].reshape(size, 7)
        weights = np.array([64, 32, 16, 8, 4, 2, 1], dtype=np.uint16)
        flat_lengths[C.STREAM_BASE[s] : C.STREAM_BASE[s] + size] = (
            field.astype(np.uint16) @ weights
        ).astype(np.uint8)
        pos += size * C.AOB_FIELD_BITS
    return flat_lengths
