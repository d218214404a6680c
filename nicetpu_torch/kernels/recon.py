"""The row reconstruction (the decoder's serial value chain) on the card.

Counterpart of `nicetpu/kernels/recon_pallas.py`.  The wrapper launches the
CUDA kernel `nt_reconstruct_rows` (`csrc/decode_kernels.cu`) for CUDA
tensors and runs the plain version, `decode_dev.reconstruct_rows`, for CPU
ones.  Both read zeros before the raster start.  The kernel runs the
segment-LUT scheme of the JAX `decode_dev.reconstruct_rows` (segments of
32 pixels, 256 candidate entry values each) one block per (image, channel);
the Pallas kernel's 128-lane segments, the `MAX_BS` batch chunking and the
B=1 padding are TPU artefacts and are not carried over: the kernel takes
every width >= MIN_WIDTH and any batch.
"""

from __future__ import annotations

import ctypes

import torch

from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels import build, cuda_ops, decode_dev


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
    # rows too wide for a block's shared memory keep the kernel's buffers in
    # device memory, one stretch per (image, channel)
    stride = build.load().nt_recon_scratch_bytes(width, form.device.index)
    if stride < 0:
        raise RuntimeError(f"nt_recon_scratch_bytes failed for width {width}")
    scratch = None
    if stride:
        scratch = torch.empty(3 * B, stride, dtype=torch.uint8, device=form.device)
    cuda_ops.launch(
        "reconstruct_rows", "nt_reconstruct_rows", cuda_ops.ptr(form), cuda_ops.ptr(delta),
        cuda_ops.ptr(refoff), cuda_ops.ptr(out),
        cuda_ops.ptr(scratch) if scratch is not None else ctypes.c_void_p(0),
        ctypes.c_int(B), ctypes.c_int(N), ctypes.c_int(width), device=form.device,
    )
    return out
