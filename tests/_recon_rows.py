"""Inputs of the row reconstruction for its tests, JAX-free (the card tests
import it too): random forms, deltas and CONST references, and the same
with every column near a segment boundary or a row end made CONST (each
offset in turn), lag 2 or lag 3, so that the slice seams of every cluster
size and the row's wrap are crossed."""

from __future__ import annotations

import numpy as np
import torch

from nicetpu_torch.kernels import decode_dev


def random_inputs(B: int, H: int, W: int, seed: int) -> list[torch.Tensor]:
    """form, delta, refoff as int32 tensors: forms 0..4, CONST references
    drawn from the width's offsets."""
    rng = np.random.default_rng(seed)
    N = H * W
    form = rng.integers(0, 5, (B, N)).astype(np.int32)
    delta = rng.integers(0, 256, (B, 3, N)).astype(np.int32)
    choices = np.array([0] + decode_dev._const_offsets(W), np.int32)
    refoff = np.where(form == 0, rng.choice(choices, (B, N)), 0).astype(np.int32)
    return [torch.from_numpy(a) for a in (form, delta, refoff)]


def seam_inputs(B: int, H: int, W: int, seed: int, seg: int = 32) -> list[torch.Tensor]:
    """`random_inputs` with the columns within 4 of a multiple of `seg` (a
    segment boundary: every seam a cluster can have) and of the row's ends
    set, in turn, to CONST (its offsets in turn), ADD2 and ADD3."""
    form, delta, refoff = (t.numpy().reshape(B, -1, W).copy() for t in random_inputs(B, H, W, seed))
    delta = delta.reshape(B, 3, H, W)
    x = np.arange(W)
    near = (x % seg < 4) | (x % seg >= seg - 4) | (x < 4) | (x >= W - 4)
    offs = np.array(decode_dev._const_offsets(W), np.int32)
    idx = (np.arange(H)[:, None] * W + x[None, :])[:, near]  # (H, near) pixel numbers
    f = np.array([0, 2, 3], np.int32)[idx % 3]
    ro = np.where(f == 0, offs[(idx // 3) % len(offs)], 0)
    form[:, :, near] = f
    refoff[:, :, near] = ro
    return [torch.from_numpy(np.ascontiguousarray(a).reshape(s))
            for a, s in ((form, (B, H * W)), (delta, (B, 3, H * W)), (refoff, (B, H * W)))]
