"""Code-length validation shared by the port's decoders.

The port's copy of `nicetpu.format.huffman.validate_flat_lengths`.
"""

from __future__ import annotations

import numpy as np

from nicetpu_torch.format import constants as C


def validate_flat_lengths(flat_lengths: np.ndarray) -> None:
    """Corrupt-header hardening shared by the decoders: every stream's code
    lengths must be in 1..=31 with an exactly complete Kraft sum (what every
    conforming encoder emits — full-alphabet Huffman, SURVEY §2.3.1)."""
    flat = np.asarray(flat_lengths, dtype=np.int64)
    for s in range(C.NUM_STREAMS):
        lens = flat[C.STREAM_BASE[s] : C.STREAM_BASE[s] + C.ALPHABET_SIZES[s]]
        if (lens < 1).any() or (lens > C.MAX_CODE_LEN).any():
            raise ValueError(f"corrupt stream header: stream {s} length out of range")
        if int((1 << (C.MAX_CODE_LEN - lens)).sum()) != 1 << C.MAX_CODE_LEN:
            raise ValueError(f"corrupt stream header: stream {s} Kraft sum != 1")
