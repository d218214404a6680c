"""Scan primitives for the tokenizer.

Counterpart of `nicetpu/kernels/scan.py`.  The JAX version unrolls
log-doubling shift-min steps because `lax.cummin` is slow on the TPU; the
port's plain tokenizer (`tokenize.tokenize_bins_plain`) uses `torch.cummin`
directly.  On the card the tokenizer kernel finds each next change itself
(published span words, a look-ahead, warp ballots).
"""

from __future__ import annotations

import torch


def suffix_min(x: torch.Tensor) -> torch.Tensor:
    """out[..., i] = min(x[..., i:]) along the last dimension."""
    rev = torch.flip(x, dims=(-1,))
    return torch.flip(torch.cummin(rev, dim=-1).values, dims=(-1,))
