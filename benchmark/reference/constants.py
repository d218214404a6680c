"""Frozen constants of the `.nice` format.

The benchmark's frozen copy of `nicetpu_torch/format/constants.py`, value
for value.  It belongs to the yardstick: a change to the program does not
move it.

Behavioral spec source: reference `src/code.rs:16-45` (prefixes / stream ids),
`code.rs:91-116` (alphabet sizes), `code.rs:141-145` (reference-offset tables),
`code.rs:72-84` + `code.rs:469-497` (container header).  See SURVEY.md
Appendix A for the complete derivation.  These values are part of the wire
format and must never change.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Container header (SURVEY A.1; ref code.rs:72-84)
# ---------------------------------------------------------------------------
MAGIC = b"nice"
FILE_HEADER_BYTES = 13  # magic(4) + width u32 BE + height u32 BE + channels u8
TAIL_PADDING_BYTES = 5  # [B, B, 0, 0, 0] flush tail (SURVEY A.6)

# ---------------------------------------------------------------------------
# Mode prefixes — stream 1 alphabet (ref code.rs:16-28)
# ---------------------------------------------------------------------------
PREFIX_BACK_REF = 0
PREFIX_RGB = 1
PREFIX_COLOR_LUMA = 2
PREFIX_SMALL_DIFF = 3
PREFIX_COLOR_LUMA2 = 4
# Run digits: base-8 digit d is emitted as prefix symbol d + 5 (ref code.rs:394)
PREFIX_RUN_BASE = 5  # prefixes 5..12 inclusive

# ---------------------------------------------------------------------------
# Symbol streams (ref code.rs:32-45; alphabets code.rs:91-116)
# ---------------------------------------------------------------------------
SC_RGB = 0
SC_PREFIXES = 1
SC_LUMA_BASE_DIFF = 2
SC_LUMA_OTHER_DIFF = 3
SC_LUMA_BACK_REF = 4
SC_SMALL_DIFF = 5
SC_LUMA_BASE_DIFF2 = 6
SC_LUMA_OTHER_DIFF2 = 7
SC_LUMA_OTHER_DIFFB2 = 8
SC_BACK_REF = 9

NUM_STREAMS = 10
ALPHABET_SIZES = (256, 13, 64, 32, 11, 343, 64, 32, 32, 11)

# Flat-histogram layout: bin of (stream, symbol) = STREAM_BASE[stream] + symbol
STREAM_BASE = tuple(int(x) for x in np.cumsum((0,) + ALPHABET_SIZES[:-1]))
TOTAL_SYMBOLS = int(sum(ALPHABET_SIZES))  # 858

# Stream-header bit cost is fixed: 5-bit max_aob + 7-bit aob per symbol
# (the 7 is the frozen `max_aob.next_power_of_two().count_zeros()` quirk,
# ref hfe.rs:102 — always 7 for max_aob in 1..=128; SURVEY §2.3.3).
AOB_FIELD_BITS = 7
MAX_AOB_FIELD_BITS = 5
STREAM_HEADERS_BITS = NUM_STREAMS * MAX_AOB_FIELD_BITS + TOTAL_SYMBOLS * AOB_FIELD_BITS
assert STREAM_HEADERS_BITS % 8 == 0  # 6056 bits = 757 bytes, always byte-aligned
STREAM_HEADERS_BYTES = STREAM_HEADERS_BITS // 8

# max_aob is serialized in 5 bits => code lengths must stay <= 31
# (ref hfe.rs:98 writes it unclamped; we assert instead of corrupting).
MAX_CODE_LEN = 31
# Practical cap for the one-shot decoder LUT (2^max_aob entries, ref hfe.rs:191).
MAX_LUT_AOB = 24

# ---------------------------------------------------------------------------
# Predictor reference offsets, in *pixels* (byte offsets in the reference are
# channels * these values, ref code.rs:141-145, so pixel offsets are
# channel-independent).  Probe order is first-match-wins priority order.
# ---------------------------------------------------------------------------


def back_ref_offsets(width: int) -> tuple[int, ...]:
    """BACK_REF probe offsets: (x-1,y), (x,y-1), (x+1,y-1), (x-2,y), (x,y-2)."""
    w = width
    return (1, w, w - 1, 2, 2 * w)


def luma_ref_offsets(width: int) -> tuple[int, ...]:
    """COLOR_LUMA probe offsets (11), ref code.rs:141-142.

    Pixel deltas: (x-1,y), (x,y-1), (x+1,y-1), (x+3,y-1), (x-3,y), (x+1,y-3),
    (x,y-3), (x-1,y-3), (x-3,y-1), (x-3,y-3), (x+3,y-3).
    """
    w = width
    return (
        1,
        w,
        w - 1,
        w - 3,
        3,
        3 * w - 1,
        3 * w,
        3 * w + 1,
        w + 3,
        3 * w + 3,
        3 * w - 3,
    )


NUM_BACK_REF = 5
NUM_LUMA_REF = 11

# Minimum raster width: W-3 offsets underflow/self-reference below 4
# (SURVEY §A.8.7 — reference panics or mis-encodes for W <= 3).
MIN_WIDTH = 4

# ---------------------------------------------------------------------------
# Run-length coding (SURVEY A.5; ref code.rs:385-407)
# ---------------------------------------------------------------------------
# v = run_length - 1 emitted as base-8 digits LSB-first, digit d as prefix d+5.
# Run values fit int32 (rasters < 2^31 pixels), so 11 base-8 digits suffice
# (8^11 = 2^33 > 2^31); this also keeps every threshold int32-safe on TPU.
MAX_RUN_DIGITS = 11

# ---------------------------------------------------------------------------
# Token slot layout used by the vectorized tokenizer (not wire format —
# implementation detail shared by numpy spec and JAX kernels).
# Per encoded pixel, emission order is: prefix, mode payload (<= 4 symbols),
# then run digits.  Slot order == serial token order (SURVEY §3.1 / A.6).
# ---------------------------------------------------------------------------
MODE_PAYLOAD_SLOTS = 4  # COLOR_LUMA emits the most: index + g + r + b
TOKEN_SLOTS = 1 + MODE_PAYLOAD_SLOTS + MAX_RUN_DIGITS  # 16
