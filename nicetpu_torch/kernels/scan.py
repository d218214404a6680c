"""Scan primitives for the tokenizer.

Counterpart of `nicetpu/kernels/scan.py`.  The JAX version unrolls
log-doubling shift-min steps because `lax.cummin` is slow on the TPU; on the
GPU `torch.cummin` is a single native scan, so the port uses it directly.
"""

from __future__ import annotations

import torch


def suffix_min(x: torch.Tensor) -> torch.Tensor:
    """out[..., i] = min(x[..., i:]) along the last dimension."""
    rev = torch.flip(x, dims=(-1,))
    return torch.flip(torch.cummin(rev, dim=-1).values, dims=(-1,))
