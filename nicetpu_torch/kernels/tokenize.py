"""The `.nice` tokenizer: a raster's pixels -> flat histogram bins.

Counterpart of `nicetpu/kernels/tokenize.py` (`halo_pixels`, `cascade`,
`assemble_bins`) and of the jnp program `nicetpu/kernels/encode2.py`
`_tokenize_core` that composes them with the run scan.
`tokenize_bins` is the wrapper every encode path calls: on a CUDA tensor it
launches the kernel of `csrc/tokenize_kernels.cu` (`cuda_ops.tokenize`: one
memset of its scratch, then one launch), on a CPU tensor it runs the plain
version `tokenize_bins_plain`.  The sharded encode first finds each shard's
first change with `first_change` (one launch), all-gathers it and passes the
later shards' to `tokenize_bins` as its tail.  The plain version is vectorized
elementwise torch code: all predictors are statically shifted reads of the
raster, the mode is a priority select over per-mode validity masks, and
every token slot becomes a flat histogram bin (a few hundred launches per
call on a card).  `cascade` and `assemble_bins` take any number of leading
batch dimensions: (..., pixels, 3) in, (..., pixels) or (..., pixels,
slots) out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nicetpu_torch.format import constants as C
from nicetpu_torch.kernels import cuda_ops
from nicetpu_torch.kernels.geometry import Geometry
from nicetpu_torch.kernels.scan import suffix_min


def halo_pixels(width: int) -> int:
    """Halo (in pixels) a shard needs before its first pixel: 4 rows covers
    the deepest predictor reach 3W+3 (ref code.rs:141-145) for any W >= 4."""
    return 4 * width


def _shift(x: torch.Tensor, off: int, halo: int, n_local: int) -> torch.Tensor:
    """ref[i] = x[..., halo + i - off] for local pixel i (zeros if OOB)."""
    start = halo - off
    if start >= 0:
        return x[..., start : start + n_local]
    return F.pad(x, (-start, 0))[..., :n_local]


def cascade(x_ext: torch.Tensor, g0, n_local: int, *, width: int, halo: int) -> dict:
    """Mode cascade for n_local pixels given a halo-extended flat raster.

    x_ext: (..., halo + n_local, 3) int32; halo pixels precede the local
    range.  g0: global pixel index of local pixel 0 (int or 0-d tensor).
    Returns per-pixel tensors: mode, per-mode symbols, residuals, change mask.
    """
    W = width
    r_, g_, b_ = x_ext[..., 0], x_ext[..., 1], x_ext[..., 2]
    pos = torch.arange(n_local, dtype=torch.int32, device=x_ext.device) + g0

    def sh(x, off):
        return _shift(x, off, halo, n_local)

    r, g, b = sh(r_, 0), sh(g_, 0), sh(b_, 0)
    row0 = pos < W

    pr, pg, pb = sh(r_, 1), sh(g_, 1), sh(b_, 1)
    ur, ug, ub = sh(r_, W), sh(g_, W), sh(b_, W)
    zeros_b = torch.zeros_like(r, dtype=torch.bool)
    zeros_i = torch.zeros_like(r)

    # --- BACK_REF: first exact match over 5 offsets (priority select)
    br_hit, br_idx = zeros_b, zeros_i
    for i, off in enumerate(C.back_ref_offsets(W)):
        eq = (pos >= off) & (r == sh(r_, off)) & (g == sh(g_, off)) & (b == sh(b_, off))
        br_idx = torch.where(eq & ~br_hit, i, br_idx)
        br_hit = br_hit | eq

    # --- SMALL_DIFF (ref code.rs:210-247)
    avg_r, avg_g, avg_b = (ur + pr) // 2, (ug + pg) // 2, (ub + pb) // 2
    sd_r = r - torch.where(row0, pr, avg_r)
    sd_g = g - torch.where(row0, pg, avg_g)
    sd_b = b - torch.where(row0, pb, avg_b)
    sd_hit = (pos > 0) & (sd_r.abs() <= 3) & (sd_g.abs() <= 3) & (sd_b.abs() <= 3)
    sd_code = (3 + sd_r) + 7 * (3 + sd_g) + 49 * (3 + sd_b)

    def luma_diffs(rr, rg, rb):
        dg = (g - rg) & 255
        dr = (r - rr - dg) & 255
        db = (b - rb - dg) & 255
        ok = ((dg >= 224) | (dg < 32)) & ((dr >= 240) | (dr < 16)) & ((db >= 240) | (db < 16))
        return dg, dr, db, ok

    # --- COLOR_LUMA2 (ref code.rs:252-292)
    l2_g, l2_r, l2_b, l2_ok = luma_diffs(avg_r, avg_g, avg_b)
    l2_hit = ~row0 & l2_ok

    # --- COLOR_LUMA: 11 refs, first in-range wins (ref code.rs:295-339)
    lu_hit = zeros_b
    lu_idx = lu_g = lu_r = lu_b = zeros_i
    for i, off in enumerate(C.luma_ref_offsets(W)):
        dg, dr, db, ok = luma_diffs(sh(r_, off), sh(g_, off), sh(b_, off))
        ok = ok & (pos >= off)
        new = ok & ~lu_hit
        lu_idx = torch.where(new, i, lu_idx)
        lu_g = torch.where(new, dg, lu_g)
        lu_r = torch.where(new, dr, lu_r)
        lu_b = torch.where(new, db, lu_b)
        lu_hit = lu_hit | ok

    # --- RGB residuals (ref code.rs:341-366); pixel-0 predictor = 0
    first = pos > 0
    res_r = torch.where(row0, (r - torch.where(first, pr, 0)) & 255, (r - avg_r) & 255)
    res_g = torch.where(row0, (g - torch.where(first, pg, 0)) & 255, (g - avg_g) & 255)
    res_b = torch.where(row0, (b - torch.where(first, pb, 0)) & 255, (b - avg_b) & 255)

    mode = torch.full_like(r, C.PREFIX_RGB)
    mode = torch.where(lu_hit, C.PREFIX_COLOR_LUMA, mode)
    mode = torch.where(l2_hit, C.PREFIX_COLOR_LUMA2, mode)
    mode = torch.where(sd_hit, C.PREFIX_SMALL_DIFF, mode)
    mode = torch.where(br_hit, C.PREFIX_BACK_REF, mode)

    changed = (r != pr) | (g != pg) | (b != pb) | (pos == 0)

    return {
        "pos": pos,
        "mode": mode,
        "br_idx": br_idx,
        "sd_code": sd_code,
        "l2": (l2_g, l2_r, l2_b),
        "lu": (lu_idx, lu_g, lu_r, lu_b),
        "res": (res_r, res_g, res_b),
        "changed": changed,
    }


def assemble_bins(cas: dict, run_len: torch.Tensor, *, ndigits_cap: int, invalid_bin: int):
    """Token slots directly as flat histogram bins (..., n, 5 + ndigits_cap).

    Stream bases are folded into the per-slot selects; invalid slots get
    `invalid_bin`; slot order is serial token order.  Returns (bins int32,
    overflow bool of shape (...)) where overflow says some run needs more
    than `ndigits_cap` base-8 digits.
    """
    mode = cas["mode"]
    enc = cas["changed"]
    br_idx = cas["br_idx"]
    sd_code = cas["sd_code"]
    l2_g, l2_r, l2_b = cas["l2"]
    lu_idx, lu_g, lu_r, lu_b = cas["lu"]
    res_r, res_g, res_b = cas["res"]

    is_br = mode == C.PREFIX_BACK_REF
    is_sd = mode == C.PREFIX_SMALL_DIFF
    is_l2 = mode == C.PREFIX_COLOR_LUMA2
    is_lu = mode == C.PREFIX_COLOR_LUMA

    has_run = enc & (run_len > 0)
    v = torch.clamp(run_len - 1, min=0)
    ndigits = torch.ones_like(v)
    for j in range(1, C.MAX_RUN_DIGITS):
        ndigits = ndigits + (v >= (1 << (3 * j))).to(v.dtype)

    B = C.STREAM_BASE

    def gate(cond, val):
        return torch.where(cond, val, invalid_bin)

    slots = [gate(enc, B[C.SC_PREFIXES] + mode)]
    s1 = torch.where(is_lu, B[C.SC_LUMA_BACK_REF] + lu_idx, B[C.SC_RGB] + res_r)
    s1 = torch.where(is_l2, B[C.SC_LUMA_BASE_DIFF2] + ((l2_g + 32) & 255), s1)
    s1 = torch.where(is_sd, B[C.SC_SMALL_DIFF] + sd_code, s1)
    s1 = torch.where(is_br, B[C.SC_BACK_REF] + br_idx, s1)
    slots.append(gate(enc, s1))
    s2 = torch.where(is_lu, B[C.SC_LUMA_BASE_DIFF] + ((lu_g + 32) & 255), B[C.SC_RGB] + res_g)
    s2 = torch.where(is_l2, B[C.SC_LUMA_OTHER_DIFF2] + ((l2_r + 16) & 255), s2)
    three = enc & ~(is_br | is_sd)
    slots.append(gate(three, s2))
    s3 = torch.where(is_lu, B[C.SC_LUMA_OTHER_DIFF] + ((lu_r + 16) & 255), B[C.SC_RGB] + res_b)
    s3 = torch.where(is_l2, B[C.SC_LUMA_OTHER_DIFFB2] + ((l2_b + 16) & 255), s3)
    slots.append(gate(three, s3))
    # slot 4 (COLOR_LUMA only)
    slots.append(gate(enc & is_lu, B[C.SC_LUMA_OTHER_DIFF] + ((lu_b + 16) & 255)))
    # run digit slots
    for j in range(ndigits_cap):
        slots.append(
            gate(
                has_run & (j < ndigits),
                B[C.SC_PREFIXES] + ((v >> (3 * j)) & 7) + C.PREFIX_RUN_BASE,
            )
        )
    bins = torch.stack(slots, dim=-1)
    if ndigits_cap < C.MAX_RUN_DIGITS:
        overflow = (has_run & (ndigits > ndigits_cap)).any(dim=-1)
    else:
        overflow = torch.zeros(mode.shape[:-1], dtype=torch.bool, device=mode.device)
    return bins, overflow


# ---------------------------------------------------------------------------
# the whole tokenizer: cascade, the next change of every pixel, the bins
# ---------------------------------------------------------------------------


def _check_tokenize(x_ext, *, halo: int, g0: int, n_total: int, width: int = C.MIN_WIDTH,
                    ndigits_cap: int = 0, tail=None) -> None:
    """Raise on what the kernel does not take."""
    if not isinstance(x_ext, torch.Tensor):
        raise TypeError("x_ext must be a torch.Tensor")
    if x_ext.dtype != torch.uint8:
        raise TypeError(f"x_ext must be uint8, got {x_ext.dtype}")
    if x_ext.dim() != 3 or x_ext.shape[2] != 3 or x_ext.shape[0] == 0:
        raise ValueError(f"x_ext must be (B, halo + n_local, 3) with B >= 1, got {tuple(x_ext.shape)}")
    if not x_ext.is_contiguous():
        raise ValueError("x_ext must be contiguous")
    if x_ext.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x_ext is on unsupported device {x_ext.device}")
    if width < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH}, got {width}")
    n_local = x_ext.shape[1] - halo
    if halo < 0 or n_local < 1:
        raise ValueError(f"halo {halo} leaves no local pixel of {x_ext.shape[1]}")
    if g0 < 0 or g0 + n_local > n_total or n_total >= 2**31:
        raise ValueError(f"pixels [{g0}, {g0 + n_local}) do not lie in a raster of {n_total} < 2**31")
    if not 0 <= ndigits_cap <= C.MAX_RUN_DIGITS:
        raise ValueError(f"ndigits_cap must be in 0..{C.MAX_RUN_DIGITS}, got {ndigits_cap}")
    if tail is not None:
        if tail.dtype != torch.int32 or tail.dim() != 1 or not tail.is_contiguous():
            raise ValueError("tail must be a contiguous 1-D int32 tensor")
        if tail.device != x_ext.device:
            raise ValueError(f"tail is on {tail.device}, x_ext on {x_ext.device}")


def first_change_plain(x_ext: torch.Tensor, *, halo: int, g0: int, n_total: int) -> torch.Tensor:
    """(B, halo + n_local, 3) uint8 -> (B,) int32: each image's first changed
    global position among its local pixels (a pixel that differs from the
    one before it, or pixel 0 of the raster), else n_total."""
    n_local = x_ext.shape[1] - halo
    x = x_ext.to(torch.int32)
    pos = torch.arange(n_local, dtype=torch.int32, device=x.device) + g0
    changed = (x[:, halo:] != _shift(x.transpose(1, 2), 1, halo, n_local).transpose(1, 2)).any(dim=2)
    return torch.where(changed | (pos == 0), pos, n_total).amin(dim=1).to(torch.int32)


def first_change(x_ext: torch.Tensor, *, halo: int, g0: int, n_total: int) -> torch.Tensor:
    """`first_change_plain`, on a CUDA tensor one launch of the kernel's
    `first_change_kernel`.  The sharded encode all-gathers it before
    `tokenize_bins` with the later shards' as `tail=`."""
    _check_tokenize(x_ext, halo=halo, g0=g0, n_total=n_total)
    if x_ext.device.type == "cpu":
        return first_change_plain(x_ext, halo=halo, g0=g0, n_total=n_total)
    return cuda_ops.first_change(x_ext, halo=halo, g0=g0, n_total=n_total)


def tokenize_bins_plain(x_ext: torch.Tensor, *, width: int, halo: int, g0: int, n_total: int,
                        ndigits_cap: int, invalid_bin: int, tail=None):
    """The composition the kernel replaces: `cascade`, then each pixel's next
    change (a suffix minimum over the changed positions, ended by n_total
    and by the smallest entry of `tail`), then `assemble_bins`.

    x_ext: (B, halo + n_local, 3) uint8, halo pixels before the local ones;
    g0: the global position of local pixel 0.  Returns (bins (B, n_local *
    (5 + ndigits_cap)) int32 in serial slot order with `invalid_bin` holes,
    overflow (B,) bool: a run needs more than ndigits_cap base-8 digits)."""
    n_local = x_ext.shape[1] - halo
    cas = cascade(x_ext.to(torch.int32), g0, n_local, width=width, halo=halo)
    pos = cas["pos"]
    sfx = suffix_min(torch.where(cas["changed"], pos, n_total))
    next_change = torch.cat([sfx[:, 1:], sfx.new_full((sfx.shape[0], 1), n_total)], dim=1)
    if tail is not None and tail.numel():
        next_change = torch.minimum(next_change, tail.min())
    bins, overflow = assemble_bins(cas, next_change - pos - 1, ndigits_cap=ndigits_cap,
                                   invalid_bin=invalid_bin)
    return bins.reshape(bins.shape[0], -1), overflow


def tokenize_bins(x_ext: torch.Tensor, *, width: int, halo: int, g0: int, n_total: int, ndigits_cap: int,
                  invalid_bin: int, tail=None):
    """`tokenize_bins_plain`, bit for bit.  On a CUDA tensor: the kernel, one
    launch after one memset, and no host sync; on a CPU tensor: the plain
    version.  tail: None or a 1-D int32 tensor on x_ext's device (the first
    changes of the later shards)."""
    _check_tokenize(x_ext, width=width, halo=halo, g0=g0, n_total=n_total, ndigits_cap=ndigits_cap,
                    tail=tail)
    kw = dict(width=width, halo=halo, g0=g0, n_total=n_total, ndigits_cap=ndigits_cap,
              invalid_bin=invalid_bin)
    if x_ext.device.type == "cpu":
        return tokenize_bins_plain(x_ext, tail=tail, **kw)
    return cuda_ops.tokenize(x_ext, tail, **kw)


def tokenize_images(x: torch.Tensor, *, geom: Geometry, ndigits_cap: int, invalid_bin: int):
    """`tokenize_bins` of a batch of whole images of any shapes: x (B, N, 3)
    uint8, each image zero past its own pixels (`geom`, N its largest
    image's).  Each image is tokenized as its own raster, as if alone, and
    its bins past its pixels are holes.  On a CUDA tensor: the kernel with
    the batch's table, one launch after one memset."""
    kw = dict(halo=0, g0=0, n_total=geom.n_max, ndigits_cap=ndigits_cap)
    _check_tokenize(x, width=min(geom.widths), **kw)  # the narrowest image's width checks them all
    B, n = x.shape[:2]
    if (geom.batch, geom.n_max) != (B, n):
        raise ValueError(f"a geometry of {geom.batch} images up to {geom.n_max} pixels for a "
                         f"{tuple(x.shape)} batch")
    if x.device.type == "cuda":
        return cuda_ops.tokenize(x, None, width=min(geom.widths), invalid_bin=invalid_bin, geo=geom.table, **kw)
    S = 5 + ndigits_cap
    bins = torch.full((B, n * S), invalid_bin, dtype=torch.int32)
    overflow = torch.zeros(B, dtype=torch.bool)
    for b, (w, nb) in enumerate(zip(geom.widths, geom.n_pixels)):
        kw.update(n_total=nb)
        one, ovf = tokenize_bins_plain(x[b : b + 1, :nb], width=w, invalid_bin=invalid_bin, **kw)
        bins[b, : nb * S], overflow[b] = one[0], ovf[0]
    return bins, overflow
