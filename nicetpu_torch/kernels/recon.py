"""The row reconstruction (the decoder's serial value chain) on the card.

Counterpart of `nicetpu/kernels/recon_pallas.py`.  The wrapper launches the
CUDA kernel `nt_reconstruct_rows` (`csrc/decode_kernels.cu`) for CUDA
tensors and runs the plain version, `decode_dev.reconstruct_rows`, for CPU
ones.  Both read zeros before the raster start, or, given the carry
`prev4`, the four rows before a row block (the sharded decode's carry
pipeline).  The kernel runs the segment-LUT scheme of the JAX
`decode_dev.reconstruct_rows` (segments of 32 pixels, 256 candidate entry
values each) on each (image, channel) chain in turn through its rows, and
on a width it observes picks where a chain runs (`chain_plan`):

* rows whose buffers (about 53 bytes a pixel) fit one block's shared
  memory, up to about 4,288 pixels on an H100, run on one block a chain;
* wider rows run on a thread-block cluster a chain, of the fewest CTAs,
  a power of two up to 16, that give each at most about 1,024 columns (8
  or 16 on an H100; 16 was faster than 8 at 16,384 wide, PERF.md §6).  Each CTA owns a
  column slice of whole segments and holds its buffers and its columns of
  the four-row ring in its own shared memory; the slices' edges and the
  row's wrap read the rows above from the neighbouring CTAs (distributed
  shared memory).  A row's resolve gains a level: each CTA composes its
  segments into one LUT triple, every CTA carries the row's entry triple
  across the triples of the CTAs before it, then across its own groups
  and segments.  The last CTA fixes up the row's last three columns from
  the first CTA's first three pixels;
* rows past what a 16-CTA cluster holds (about 63,000 pixels) run on one
  block with the buffers in device-memory scratch.

Bound: 32 bytes a pixel is the least the card could take, but the scheme
does 256 candidates of work a pixel on the SMs it occupies: 3 * B on one
block a chain, 3 * B * C on clusters of C, which pay two cluster barriers
a row.  The Pallas kernel's 128-lane segments, the `MAX_BS` batch chunking
and the B=1 padding are TPU artefacts and are not carried over: the kernel
takes every width >= MIN_WIDTH and any batch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels import build, cuda_ops, decode_dev
from nicetpu_torch.kernels.geometry import Geometry


@functools.lru_cache(maxsize=None)
def _plan(width: int, index: int) -> tuple[int, int]:
    """`nt_recon_plan`, asked once a width and device: (CTAs a chain runs
    on, device-memory scratch bytes a chain).  (1, 0) is one block, (2..16,
    0) a cluster, (0, bytes) one block with its buffers in device memory."""
    ctas, scratch = ctypes.c_int(0), ctypes.c_longlong(0)
    lib = build.load()
    err = lib.nt_recon_plan(width, index, ctypes.byref(ctas), ctypes.byref(scratch))
    if err != 0:
        what = lib.nt_error_string(err).decode()
        raise RuntimeError(f"nt_recon_plan failed for width {width}: {what} ({err})")
    return ctas.value, scratch.value


def chain_plan(width: int, device) -> tuple[int, int]:
    """Where a chain of this width runs on a CUDA device: (CTAs, scratch
    bytes a chain), as `_plan`."""
    device = torch.device(device)
    return _plan(width, device.index if device.index is not None else torch.cuda.current_device())


def chain_path(width: int, device) -> int:
    """Which path a chain of this width runs on: the CTAs of `chain_plan`
    (1 one block, 2..16 a cluster, 0 one block with device-memory
    scratch); 1 on the CPU.  One launch takes one path."""
    if torch.device(device).type != "cuda":
        return 1
    return chain_plan(width, device)[0]


def cluster_ctas(width: int, device) -> int:
    """The CTAs of the thread-block cluster that reconstructs one chain of
    this width on `device`; 0 where a chain runs on one block, and on the
    CPU."""
    if torch.device(device).type != "cuda":
        return 0
    ctas = chain_plan(width, device)[0]
    return ctas if ctas > 1 else 0


def reconstruct_rows(form, delta, refoff, *, width: int | None = None, geom: Geometry | None = None,
                     prev4=None, stats: dict | None = None):
    """form, refoff (B, N) int32; delta (B, 3, N) int32 channel-planar;
    refoff holds 0 or one of `decode_dev._const_offsets(width)`.  Returns the
    (B, 3, N) int32 chain values.

    One of width (every image's; the kernel takes it without a table) and
    geom (the batch's `geometry.Geometry`): each image then reconstructs
    its own pixels at its own width (its chains' rows are N_b / W_b), and
    its values past N_b are zeros.  Every width of one batch must run on
    the same path (`chain_plan`).

    prev4: optional (B, 3, 4 * width) int32 carry, the four rows before the
    block, oldest first, with values in 0..255 (a row block decoded after
    the rows above it, as across ranks; with width, not geom).  With it the
    result is (out, tail), tail the last four rows of carry and block: the
    next block's carry.

    stats: a dict whose "recon_chains" gains the (image, channel) chains
    reconstructed, 3 * B, and "recon_cluster_chains" those that ran on a
    thread-block cluster (0 on the CPU and on one block)."""
    cuda_ops.check(form, "form", 2)
    cuda_ops.check(delta, "delta", 3)
    cuda_ops.check(refoff, "refoff", 2)
    cuda_ops.same_device(form, delta, refoff)
    B, N = form.shape
    if refoff.shape != (B, N) or delta.shape != (B, 3, N):
        raise ValueError(f"form {tuple(form.shape)}, delta {tuple(delta.shape)} and "
                         f"refoff {tuple(refoff.shape)} disagree")
    if (width is None) == (geom is None):
        raise ValueError("reconstruct_rows takes one of width and geom")
    if geom is not None:
        if geom.batch != B or geom.n_max != N or prev4 is not None:
            raise ValueError(f"a geometry of {geom.batch} images up to {geom.n_max} pixels for a ({B}, {N}) "
                             f"batch{' with a carry' if prev4 is not None else ''}")
        shapes = list(zip(geom.widths, geom.n_pixels))
        width = geom.width_max
    else:
        shapes = [(width, N)] * B
    if any(w < C.MIN_WIDTH or n % w for w, n in shapes):
        raise ValueError(f"each width must be >= {C.MIN_WIDTH} and divide its image's N (N = {N})")
    if prev4 is not None:
        cuda_ops.check(prev4, "prev4", 3)
        cuda_ops.same_device(form, prev4)
        if prev4.shape != (B, 3, 4 * width):
            raise ValueError(f"prev4 must be ({B}, 3, {4 * width}), got {tuple(prev4.shape)}")
    if form.device.type == "cpu":
        ctas, res = 1, _plain(form, delta, refoff, shapes, prev4)
    else:
        ctas, res = _launch(form, delta, refoff, prev4, B, N, width, geom)
    if stats is not None:
        stats["recon_chains"] = stats.get("recon_chains", 0) + 3 * B
        stats["recon_cluster_chains"] = stats.get("recon_cluster_chains", 0) + (3 * B if ctas > 1 else 0)
    return res


def _plain(form, delta, refoff, shapes, prev4):
    """The plain version, image by image where the shapes differ."""
    B, N = form.shape
    if len(set(shapes)) == 1 and shapes[0][1] == N:
        return decode_dev.reconstruct_rows(form, delta, refoff, N, shapes[0][0], prev4=prev4)
    out = torch.zeros(B, 3, N, dtype=torch.int32)
    for b, (w, n) in enumerate(shapes):
        out[b, :, :n] = decode_dev.reconstruct_rows(form[b : b + 1, :n], delta[b : b + 1, :, :n],
                                                    refoff[b : b + 1, :n], n, w)[0]
    return out


def _launch(form, delta, refoff, prev4, B: int, N: int, width: int, geom):
    """The kernel on a CUDA device: (the CTAs a chain ran on, the result).
    width: the batch's widest image's; geom: its Geometry, or None."""
    if 3 * B > 2**31 - 1 or N >= 2**31:
        raise ValueError(f"reconstruct_rows shape ({B}, {N}) out of range")
    out = torch.empty(B, 3, N, dtype=torch.int32, device=form.device)
    ctas, stride = chain_plan(width, form.device)
    if geom is not None and any(chain_path(w, form.device) != ctas for w in set(geom.widths)):
        raise ValueError(f"the widths {sorted(set(geom.widths))} run on different reconstruction paths")
    # rows too wide for a cluster's shared memory keep the kernel's buffers
    # in device memory, one stretch per (image, channel)
    scratch = torch.empty(3 * B, stride, dtype=torch.uint8, device=form.device) if stride else None
    null = ctypes.c_void_p(0)
    cuda_ops.launch(
        "reconstruct_rows", "nt_reconstruct_rows", cuda_ops.ptr(form), cuda_ops.ptr(delta),
        cuda_ops.ptr(refoff), cuda_ops.ptr(prev4) if prev4 is not None else null,
        cuda_ops.ptr(out), cuda_ops.ptr(scratch) if scratch is not None else null, ctypes.c_int(ctas),
        cuda_ops.ptr(geom.table) if geom is not None else null,
        ctypes.c_int(B), ctypes.c_int(N), ctypes.c_int(width), device=form.device,
    )
    if ctas > 1:
        cuda_ops.count_launch("reconstruct_rows_cluster")
    if prev4 is None:
        return ctas, out
    tail = out[:, :, N - 4 * width :] if N >= 4 * width else torch.cat([prev4, out], dim=2)[:, :, N:]
    return ctas, (out, tail.contiguous())
