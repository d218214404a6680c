"""Per-image raster geometry of a device batch.

A device batch of the round trip holds images of any shapes: their pixels
are one (B, N, 3) upload, N the largest image's pixel count, zero past each
image's own N_b.  What an image's kernels and torch steps need of its shape
travels as one (B, COLS) int32 table on the batch's device, uploaded once a
batch, one row an image:

    column W            the image's width
    column N            its pixel count
    BR_LAG, BR_REFI     BACK_REF's probe index -> its lag (1..3, else 0) and
                        its CONST offset's index in OFFS (0 for a lag)
    LU_LAG, LU_REFI     the same for COLOR_LUMA's probes
    OFFS                0, then `decode_dev._const_offsets(width)`, zero-padded

The fused round trip and the decode core take a batch's geometry as one
keyword, `geom`; a caller that holds one shape builds `Geometry.uniform`
once.  The CUDA kernels read an image's width and pixel count from the
table (`csrc/common.cuh`, `geo_width` / `geo_pixels`, kGeoCols).  The
kernel wrappers also take one raster's scalars and pass no table, for the
callers that hold a slice of one raster (the sharded codec's halo, carry
and global offsets) and for one-shape kernel tests.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels.decode_dev import _const_offsets

W, N = 0, 1
BR_LAG, BR_REFI = slice(2, 7), slice(7, 12)
LU_LAG, LU_REFI = slice(12, 23), slice(23, 34)
OFFS = slice(34, 50)
COLS = 50  # as kGeoCols in csrc/common.cuh


def _split(tbl, offs):
    """A probe table's (lag 1..3 | 0) and (ref index | 0) maps."""
    lag = tuple(o if 1 <= o <= 3 else 0 for o in tbl)
    refi = tuple(0 if 1 <= o <= 3 else offs.index(o) + 1 for o in tbl)
    return lag, refi


@functools.lru_cache(maxsize=4096)
def row(width: int, n_pixels: int) -> np.ndarray:
    """One image's row of the table, (COLS,) int32 (read-only).  The
    callers check the shape: the table holds what it is given."""
    offs = _const_offsets(width)
    out = np.zeros(COLS, np.int32)
    out[W], out[N] = width, n_pixels
    out[BR_LAG], out[BR_REFI] = _split(C.back_ref_offsets(width), offs)
    out[LU_LAG], out[LU_REFI] = _split(C.luma_ref_offsets(width), offs)
    out[OFFS.start : OFFS.start + 1 + len(offs)] = (0, *offs)
    out.setflags(write=False)
    return out


class Geometry:
    """The widths and pixel counts of a device batch's images, on the host
    and as the (B, COLS) table on `device` (one copy up, which waits for
    no device work).  The callers check the shapes: the table holds what it
    is given."""

    def __init__(self, widths: Sequence[int], n_pixels: Sequence[int], device):
        self.widths = tuple(int(w) for w in widths)
        self.n_pixels = tuple(int(n) for n in n_pixels)
        if not self.widths or len(self.widths) != len(self.n_pixels):
            raise ValueError("a geometry holds a width and a pixel count for each of one or more images")
        # the host table outlives its copy up, which does not wait for it
        self._host = torch.from_numpy(np.stack([row(w, n) for w, n in zip(self.widths, self.n_pixels)]))
        self.table = self._host.to(device, non_blocking=True)

    @classmethod
    def of_shapes(cls, shapes: Sequence[tuple[int, int]], device) -> "Geometry":
        """From the images' (H, W)."""
        return cls([w for _, w in shapes], [h * w for h, w in shapes], device)

    @classmethod
    def uniform(cls, width: int, n_pixels: int, batch: int, device) -> "Geometry":
        """B images of one shape (the callers that pass scalars)."""
        return cls([width] * batch, [n_pixels] * batch, device)

    @property
    def batch(self) -> int:
        return len(self.widths)

    @property
    def n_max(self) -> int:
        """Pixels of the largest image: the batch's row length."""
        return max(self.n_pixels)

    @property
    def width_max(self) -> int:
        return max(self.widths)

    def column(self, col: int) -> torch.Tensor:
        """A (B, 1) int32 column of the table: W or N."""
        return self.table[:, col : col + 1]


def lookup(key: torch.Tensor, table: torch.Tensor, cols: slice) -> torch.Tensor:
    """table[b, cols][key] for each image b's keys; keys outside the
    columns select the first, as the JAX `_sel` chain of selects does.  key
    (B, K) or, with a one-image table, (K,)."""
    t = table[:, cols]
    k = t.shape[1]
    idx = torch.where((key >= 0) & (key < k), key, 0).to(torch.int64)
    if key.dim() == 1:
        return t[0][idx]
    return t.expand(key.shape[0], k).gather(1, idx)
