"""Conversion of the state that crosses between encode stages.

The codec has no learned parameters.  What passes from one stage to the
next is the per-image Huffman tables (lengths (B, 858) int32, codes
(B, 858) uint32) and the packed payload words (B, w_cap) uint32.  The JAX
package returns these as numpy uint32 arrays; the port carries uint32 as
int32 tensors with the same bit pattern, because torch has no uint32
arithmetic.  What enters the first stage is an (H, W, 3) uint8 raster:
`to_rgb` brings RGB and RGBA input to it.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """Integer values in [0, 2^32) -> int32 tensor with the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def from_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 tensor of the uint32 values they carry."""
    return x.to(torch.int64) & MASK32


def tables_from_numpy(lengths: np.ndarray, codes: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(lengths, codes) numpy (B, 858) -> int32 tensors on `device`; codes
    keep their uint32 bit pattern."""
    lengths = np.array(lengths, dtype=np.int32)  # a writable copy
    codes = np.array(codes, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(lengths).to(device), torch.from_numpy(codes).to(device)


def to_rgb(img: np.ndarray, alpha: str = "drop") -> np.ndarray:
    """Normalize to (H, W, 3) uint8 (the port's copy of `nicetpu.api._to_rgb`).

    The `.nice` wire format cannot round-trip alpha: the reference encoder
    accepts RGBA but its decoder reconstructs 3 bytes/pixel unconditionally
    (ref code.rs:659; SURVEY A.8.3), so reference channels=4 files are
    undecodable even by the reference itself.  This codec therefore always
    writes channels=3; `alpha` controls the RGBA policy:
      "drop"  - discard the alpha plane (the reference encoder's behavior)
      "error" - refuse RGBA input outright
    """
    if img.ndim != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, C) uint8 image")
    if img.shape[2] == 4:
        if alpha == "error":
            raise ValueError(
                "RGBA input refused (alpha='error'): .nice cannot round-trip "
                "alpha (SURVEY A.8.3)"
            )
        if alpha != "drop":
            raise ValueError(f"unknown alpha policy {alpha!r}")
        img = img[:, :, :3]
    if img.shape[2] != 3:
        raise ValueError("expected RGB or RGBA image")
    return np.ascontiguousarray(img)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32 array on the host."""
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32 bit patterns, got {words.dtype}")
    return words.cpu().numpy().view(np.uint32)
