"""The row reconstruction (the decoder's serial value chain) on the card.

Counterpart of `nicetpu/kernels/recon_pallas.py`.  The wrapper launches the
CUDA kernel `nt_reconstruct_rows` (`csrc/decode_kernels.cu`) for CUDA
tensors and runs the plain version, `decode_dev.reconstruct_rows`, for CPU
ones.  Both read zeros before the raster start, or, given the carry
`prev4`, the four rows before a row block (the sharded decode's carry
pipeline).  The kernel runs the segment-LUT scheme of the JAX
`decode_dev.reconstruct_rows` (segments of 32 pixels, 256 candidate entry
values each) one block per (image, channel);
the Pallas kernel's 128-lane segments, the `MAX_BS` batch chunking and the
B=1 padding are TPU artefacts and are not carried over: the kernel takes
every width >= MIN_WIDTH and any batch.
"""

from __future__ import annotations

import ctypes

import torch

from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels import build, cuda_ops, decode_dev


def reconstruct_rows(form, delta, refoff, *, width: int, prev4=None):
    """form, refoff (B, N) int32; delta (B, 3, N) int32 channel-planar;
    refoff holds 0 or one of `decode_dev._const_offsets(width)`.  Returns the
    (B, 3, N) int32 chain values.

    prev4: optional (B, 3, 4 * width) int32 carry, the four rows before the
    block, oldest first, with values in 0..255 (a row block decoded after
    the rows above it, as across ranks).  With it the result is (out, tail),
    tail the last four rows of carry and block: the next block's carry."""
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
    if prev4 is not None:
        cuda_ops.check(prev4, "prev4", 3)
        cuda_ops.same_device(form, prev4)
        if prev4.shape != (B, 3, 4 * width):
            raise ValueError(f"prev4 must be ({B}, 3, {4 * width}), got {tuple(prev4.shape)}")
    if form.device.type == "cpu":
        return decode_dev.reconstruct_rows(form, delta, refoff, N, width, prev4=prev4)
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
    null = ctypes.c_void_p(0)
    cuda_ops.launch(
        "reconstruct_rows", "nt_reconstruct_rows", cuda_ops.ptr(form), cuda_ops.ptr(delta),
        cuda_ops.ptr(refoff), cuda_ops.ptr(prev4) if prev4 is not None else null,
        cuda_ops.ptr(out), cuda_ops.ptr(scratch) if scratch is not None else null,
        ctypes.c_int(B), ctypes.c_int(N), ctypes.c_int(width), device=form.device,
    )
    if prev4 is None:
        return out
    tail = out[:, :, N - 4 * width :] if N >= 4 * width else torch.cat([prev4, out], dim=2)[:, :, N:]
    return out, tail.contiguous()
