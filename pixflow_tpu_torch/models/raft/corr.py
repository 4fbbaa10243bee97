"""RAFT's all-pairs correlation volume and its pyramid lookup: the port of
`pixflow_tpu/models/raft/corr.py` (the reference's CorrBlock,
`contrast/flow/corr.py:12-60`).

`build_corr_pyramid` takes <f1, f2> / sqrt(C) for every pixel pair as one
float32 `torch.bmm` and pools the *target* axes 2x2 for each further level.
`lookup_corr` samples a (2r+1)^2 window around each current flow target at
every level: bilinear, align_corners=True, zeros padding, which is exactly
the function of K2's grid-sample entry. On CUDA tensors it reads through
that kernel (`ops/kernels/point_sample.py:grid_sample_with_grad`: the entry
forward, bit for bit, and its own backward kernel for the pyramid's
gradient, so that RAFT trains on the card); on CPU tensors, or with
`plain=True`, through the plain gather `ops/resample.py:grid_sample`, whose
op order the kernel repeats bit for bit and whose autograd gives the
gradient there. Either way the gradient reaches the pyramid, and through
the pooling and the product the feature maps; the sampling coordinates
take none (RAFT detaches them). The JAX package's tent
einsum form (`lookup_corr_mxu`) exists for the TPU, whose gathers do not
vectorise; it is not ported.

A level is [N, h_l, w_l, 1] with N = B*H*W: as an NHWC field with one
channel it is also a valid NCHW tensor [N, 1, h_l, w_l]."""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from ...ops import kernels
from ...ops import resample
from ...ops.resample import inv_f32

# the kernel's offsets are 32-bit: a level's leading axis is split into
# views whose field and grid each hold fewer elements than this
MAX_VIEW_ELEMENTS = 2 ** 31 - 1


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> List[torch.Tensor]:
    """fmap1, fmap2 [B, H, W, C] -> `num_levels` float32 levels
    [B*H*W, h_l, w_l, 1]; shrinking stops at 1 x 1 (tiny inputs)."""
    b, h, w, c = fmap1.shape
    with torch.autocast(fmap1.device.type, enabled=False):
        corr = torch.bmm(fmap1.reshape(b, h * w, c).float(),
                         fmap2.reshape(b, h * w, c).float().transpose(1, 2))
    corr = corr / math.sqrt(c)
    corr = corr.reshape(b * h * w, h, w, 1)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        if min(corr.shape[1:3]) >= 2:
            # [N, h, w, 1] is [N, 1, h, w] in NCHW: pool the target axes
            corr = F.avg_pool2d(corr.reshape(-1, 1, *corr.shape[1:3]), 2, 2)
            corr = corr.reshape(corr.shape[0], corr.shape[2], corr.shape[3], 1)
        pyramid.append(corr)
    return pyramid


def window_grid(centroid: torch.Tensor, radius: int, level: int, hl: int,
                wl: int) -> torch.Tensor:
    """The normalised sampling grid [N, 2r+1, 2r+1, 2] of one level around
    centroids [N, 2] (level-0 pixels), as `lookup_corr_gather` builds it.
    The window's x-offset is the SLOW axis: the reference adds
    meshgrid(dy, dx) onto (x, y)-ordered centroids (`corr.py:37-43`), so
    grid[n, i, j] = centroid / 2^level + (off_i, off_j). A 1-wide or
    1-tall level samples its one texel."""
    off = torch.arange(-radius, radius + 1, dtype=torch.float32, device=centroid.device)
    di, dj = torch.meshgrid(off, off, indexing="ij")
    pts = centroid[:, None, None, :] * (0.5 ** level) + torch.stack([di, dj], dim=-1)
    gx = (2.0 * pts[..., 0] * inv_f32(wl - 1) - 1.0) if wl > 1 \
        else torch.zeros_like(pts[..., 0])
    gy = (2.0 * pts[..., 1] * inv_f32(hl - 1) - 1.0) if hl > 1 \
        else torch.zeros_like(pts[..., 1])
    return torch.stack([gx, gy], dim=-1)


def _read_level(corr: torch.Tensor, grid: torch.Tensor, plain: bool) -> torch.Tensor:
    """[N, h, w, 1] read at [N, Hg, Wg, 2]: per view of the leading axis
    under MAX_VIEW_ELEMENTS, through K2's grid entry on the card (with its
    backward kernel for the view's gradient)."""
    read = resample.grid_sample if plain or corr.device.type == "cpu" \
        else kernels.grid_sample_with_grad
    n = corr.shape[0]
    per_row = max(corr[0].numel(), grid[0].numel())
    rows = max(MAX_VIEW_ELEMENTS // per_row, 1)
    if rows >= n:
        return read(corr, grid)
    return torch.cat([read(corr[s:s + rows], grid[s:s + rows])
                      for s in range(0, n, rows)])


def lookup_corr(pyramid: List[torch.Tensor], coords: torch.Tensor, radius: int = 4,
                plain: bool = False) -> torch.Tensor:
    """coords [B, H, W, 2]: current target positions (level-0 pixels).
    Returns [B, H, W, num_levels * (2r+1)^2], the levels in order, each
    window with its x-offset slow."""
    b, h, w, _ = coords.shape
    win = 2 * radius + 1
    centroid = coords.reshape(b * h * w, 2).float()
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[1:3]
        grid = window_grid(centroid, radius, lvl, hl, wl)
        out.append(_read_level(corr, grid, plain).reshape(b, h, w, win * win))
    return torch.cat(out, dim=-1)
