"""Container and stream-header serialization (host-side, trivial sizes).

The benchmark's frozen copy of `nicetpu_torch/format/headers.py` (same
functions, same bytes).

File header: magic "nice", width u32 BE, height u32 BE, channels u8
(ref code.rs:72-84 / 469-482).  Stream headers: per stream a 5-bit max_aob
followed by alphabet_size x 7-bit code lengths, bit-packed MSB-first with no
alignment between streams (ref hfe.rs:97-103 / 173-204; SURVEY A.2).  The ten
headers always total exactly 757 bytes.
"""

from __future__ import annotations

import struct

import numpy as np

from benchmark.reference import constants as C


def pack_file_header(width: int, height: int, channels: int = 3) -> bytes:
    return C.MAGIC + struct.pack(">IIB", width, height, channels)


def parse_file_header(data: bytes) -> tuple[int, int, int]:
    """Returns (width, height, channels).  Magic is not validated, matching
    the reference decoder (ref code.rs:469; SURVEY A.8.4)."""
    if len(data) < C.FILE_HEADER_BYTES:
        raise ValueError("truncated .nice header")
    width, height, channels = struct.unpack(">IIB", data[4:13])
    return width, height, channels


class _BitPacker:
    """MSB-first bit packer (host-side, for the tiny fixed-size headers)."""

    def __init__(self) -> None:
        self.bits: list[tuple[int, int]] = []  # (nbits, value)

    def write(self, nbits: int, value: int) -> None:
        self.bits.append((nbits, value & ((1 << nbits) - 1)))

    def to_bytes(self) -> bytes:
        out = bytearray()
        acc = 0
        nacc = 0
        for nbits, value in self.bits:
            acc = (acc << nbits) | value
            nacc += nbits
            while nacc >= 8:
                nacc -= 8
                out.append((acc >> nacc) & 0xFF)
        if nacc:
            out.append((acc << (8 - nacc)) & 0xFF)
        return bytes(out)


def pack_stream_headers(flat_lengths: np.ndarray) -> bytes:
    """Serialize all ten stream headers from flat (858,) code lengths."""
    p = _BitPacker()
    for s in range(C.NUM_STREAMS):
        base = C.STREAM_BASE[s]
        size = C.ALPHABET_SIZES[s]
        lens = flat_lengths[base : base + size]
        p.write(C.MAX_AOB_FIELD_BITS, int(lens.max()))
        for ln in lens:
            p.write(C.AOB_FIELD_BITS, int(ln))
    out = p.to_bytes()
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
