"""Host-side payload byte assembly (numpy).

The same function as `nicetpu.kernels.bitpack.words_to_payload`, which
cannot be imported here because its module imports JAX.
"""

from __future__ import annotations

import numpy as np


def words_to_payload(words: np.ndarray, total_bits: int) -> bytes:
    """Big-endian dump of uint32 payload words -> payload bytes plus the
    5-byte flush tail [B, B, 0, 0, 0] (SURVEY A.1/A.6)."""
    n_bytes = (total_bits + 7) // 8
    raw = words[: (n_bytes + 3) // 4 + 1].astype(">u4").tobytes()
    full = total_bits // 8
    B = raw[full] if total_bits % 8 else 0
    return raw[:full] + bytes([B, B, 0, 0, 0])
