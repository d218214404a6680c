"""The row reconstruction (the decoder's serial value chain) on the card.

Counterpart of `nicetpu/kernels/recon_pallas.py`.  The wrapper launches the
CUDA kernel `nt_reconstruct_rows` (`csrc/decode_kernels.cu`) for CUDA
tensors and runs the plain version, `decode_dev.reconstruct_rows`, for CPU
ones.  Both read zeros before the raster start.  The Pallas kernel's
256-candidate segment LUTs, its 128-lane segments, the `MAX_BS` batch
chunking and the B=1 padding are TPU artefacts and are not carried over:
the kernel takes every width >= MIN_WIDTH and any batch.
"""

from __future__ import annotations

import ctypes

import torch

from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels import cuda_ops, decode_dev

# Widths up to this keep the kernel's row buffers (8 bytes a pixel of a row)
# in shared memory; wider rows use a scratch buffer in device memory, one
# 16-byte-aligned stretch per (image, channel).
SMEM_MAX_WIDTH = (227 * 1024 - 64) // 8


def _scratch_stride(width: int) -> int:
    return -(-8 * width // 16) * 16


def reconstruct_rows(form, delta, refoff, *, width: int):
    """form, refoff (B, N) int32; delta (B, 3, N) int32 channel-planar;
    refoff holds 0 or one of `decode_dev._const_offsets(width)`.  Returns the
    (B, 3, N) int32 chain values."""
    cuda_ops.check(form, "form", 2)
    cuda_ops.check(delta, "delta", 3)
    cuda_ops.check(refoff, "refoff", 2)
    cuda_ops.same_device(form, delta, refoff)
    B, N = form.shape
    if refoff.shape != (B, N) or delta.shape != (B, 3, N):
        raise ValueError(f"form {tuple(form.shape)}, delta {tuple(delta.shape)} and "
                         f"refoff {tuple(refoff.shape)} disagree")
    if width < C.MIN_WIDTH or N % width:
        raise ValueError(f"width {width} must be >= {C.MIN_WIDTH} and divide N = {N}")
    if form.device.type == "cpu":
        return decode_dev.reconstruct_rows(form, delta, refoff, N, width)
    if 3 * B > 2**31 - 1 or N >= 2**31:
        raise ValueError(f"reconstruct_rows shape ({B}, {N}) out of range")
    out = torch.empty(B, 3, N, dtype=torch.int32, device=form.device)
    scratch = None
    if width > SMEM_MAX_WIDTH:
        scratch = torch.empty(3 * B, _scratch_stride(width), dtype=torch.uint8, device=form.device)
    cuda_ops.launch(
        "reconstruct_rows", "nt_reconstruct_rows", cuda_ops.ptr(form), cuda_ops.ptr(delta),
        cuda_ops.ptr(refoff), cuda_ops.ptr(out),
        cuda_ops.ptr(scratch) if scratch is not None else ctypes.c_void_p(0),
        ctypes.c_int(B), ctypes.c_int(N), ctypes.c_int(width), device=form.device,
    )
    return out
