"""Decoder mode tables and the reconstruction's transfer forms, in PyTorch.

Counterpart of the parts of `nicetpu/kernels/decode_dev.py` that the v3
decode uses: the per-mode payload streams (`SLOT_STREAM`), the transfer
forms (`F_CONST` .. `F_HALF`, `_apply_form`), the CONST reference offsets
and the value chain itself (`reconstruct_serial`, `reconstruct_rows`).  The
v2 decoder of that module (per-bit tables, `spec_chain_mask`,
`chain_mask`) is not ported: no path of the port reaches it.

The value chain out[p] = f_p(out[p-1], out[p-2], out[p-3], out[p-W],
out[p-refoff]) is serial through the whole raster: `prev` wraps from the
end of one row to the start of the next (SURVEY A.8.2).  `reconstruct_rows`
here is the plain version of the CUDA kernel in `recon.py`; it walks the
chain pixel by pixel (vectorized over images and channels) and reads zeros
before the raster start, as the JAX `reconstruct_rows` and its Pallas
kernel do.
"""

from __future__ import annotations

import torch

from nicetpu_torch.format import constants as C

# per-mode payload slot streams (-1 = no symbol in that slot), ref
# code.rs:576-651; modes are BACK_REF, RGB, COLOR_LUMA, SMALL_DIFF, COLOR_LUMA2
SLOT_STREAM = (
    (C.SC_BACK_REF, -1, -1, -1),
    (C.SC_RGB, C.SC_RGB, C.SC_RGB, -1),
    (C.SC_LUMA_BACK_REF, C.SC_LUMA_BASE_DIFF, C.SC_LUMA_OTHER_DIFF, C.SC_LUMA_OTHER_DIFF),
    (C.SC_SMALL_DIFF, -1, -1, -1),
    (C.SC_LUMA_BASE_DIFF2, C.SC_LUMA_OTHER_DIFF2, C.SC_LUMA_OTHER_DIFFB2, -1),
)

# reconstruction transfer forms
F_CONST, F_ADD1, F_ADD2, F_ADD3, F_HALF = 0, 1, 2, 3, 4


def _apply_form(f, d, cv, ab, r1, r2, r3):
    """Element-wise transfer application; r1/r2/r3 are chain values at lags
    1..3 (shapes broadcast against f/d/cv/ab).  Any form other than CONST
    and ADD1-3 is HALF."""
    return torch.where(
        f == F_CONST,
        cv + d,
        torch.where(
            f == F_ADD1,
            r1 + d,
            torch.where(
                f == F_ADD2,
                r2 + d,
                torch.where(f == F_ADD3, r3 + d, ((ab + r1) >> 1) + d),
            ),
        ),
    ) & 255


def _const_offsets(width: int) -> list[int]:
    """Distinct CONST ref offsets (lags 1..3 ride the chain instead)."""
    offs = set(C.back_ref_offsets(width)) | set(C.luma_ref_offsets(width))
    return sorted(o for o in offs if o >= 4)


def reconstruct_serial(form, delta, refoff, n_pixels: int, width: int):
    """Exact N-step serial chain for one image, the executable spec of the
    transfer forms.  form, refoff (N,); delta (3, N) channel-planar; returns
    (3, N) int32.  Reads before the raster start clamp to pixel 0, as the
    JAX `reconstruct_serial` does (it differs from `reconstruct_rows` only
    there, which no valid stream reaches)."""
    N, W = n_pixels, width
    out = torch.zeros(3, N, dtype=torch.int32, device=form.device)
    for i in range(N):
        prev = [out[:, max(i - k, 0)] for k in (1, 2, 3)]
        above = out[:, max(i - W, 0)]
        ro = int(refoff[i])
        cval = out[:, max(i - ro, 0)] if ro > 0 else torch.zeros_like(above)
        out[:, i] = _apply_form(form[i], delta[:, i], cval, above, *prev)
    return out


def reconstruct_rows(form, delta, refoff, n_pixels: int, width: int, prev4=None):
    """The value chain for a batch, reading zeros (or the carry) before the
    block's first row: the plain version of `recon.reconstruct_rows`.

    form, refoff (B, N) int32; delta (B, 3, N) int32 channel-planar; refoff
    holds 0 or one of `_const_offsets(width)`.  Returns (B, 3, N) int32.
    prev4: optional (B, 3, 4W) int32 carry, the four rows before the block,
    oldest first (values in 0..255), as the JAX `reconstruct_rows(prev4=)`
    takes for one image; with it the result is (out, tail), tail the last
    four rows of carry and block, the next block's carry.
    One step per pixel, vectorized over images and channels: slow, and meant
    for the CPU tests and the card's check of the kernel at small sizes."""
    N, W = n_pixels, width
    B = form.shape[0]
    offs = torch.as_tensor(_const_offsets(W), dtype=torch.int32, device=form.device)
    pad = 4 * W  # four whole rows; the deepest reference (3W + 3) lands inside
    buf = torch.zeros(B, 3, pad + N, dtype=torch.int32, device=form.device)
    if prev4 is not None:
        buf[:, :, :pad] = prev4
    ro = torch.where(torch.isin(refoff, offs), refoff, 0).to(torch.int64)
    src = (pad + torch.arange(N, device=form.device))[None, :] - ro  # (B, N)
    for i in range(N):
        j = pad + i
        cv = buf.gather(2, src[:, i, None, None].expand(B, 3, 1))[:, :, 0]
        cv = torch.where(ro[:, i, None] > 0, cv, 0)
        buf[:, :, j] = _apply_form(
            form[:, i, None], delta[:, :, i], cv, buf[:, :, j - W],
            buf[:, :, j - 1], buf[:, :, j - 2], buf[:, :, j - 3],
        )
    out = buf[:, :, pad:].contiguous()
    return out if prev4 is None else (out, buf[:, :, N:].contiguous())
