"""Point-domain (lazy) evaluation of the full-resolution `flow_up` pipeline:
the port of `pixflow_tpu/ops/flow_points.py`.

The reference's FLOW_UP=y recipe upsamples every 1/8-res flow 8x, composes
the full-res fields by iterated warps, builds full-res cycle masks, and then
reads them at 49 bin centers per sample. Every quantity the loss reads is a
pointwise functional of the coarse stack, so it is evaluated only at those
points: bilinearly sampling the align-corners 8x upsample U(f) at a fine
pixel p is a separable linear functional of the coarse field (see
`kernels.point_sample.composite_weights_1d`), long-range composition is
trajectory advection of single points, and the loss's bilinear/nearest reads
are 4-tap / 1-tap blends of advected points.

Every read of U(f) goes through `sample_up`, which on the card is the K2
kernel (`kernels/point_sample.py`, `up=8`). Functions take a `sampler`
argument (default: the K2 wrapper) so a comparison run can put the plain
version in its place.

Op order. The normalise -> denormalise round trips below are deliberate:
they replicate the materialising path's float32 op order, and composition
amplifies ulp-level position differences chaotically."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .kernels.point_sample import composite_weights_1d, point_sample

__all__ = ["LazyFlowUp", "advect_up", "composed_flow_at", "composite_weights_1d",
           "cycle_mask_at", "flow_up_warp_points", "mask_ratio_estimate",
           "sample_up"]

Sampler = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def sample_up(coarse: torch.Tensor, pts: torch.Tensor,
              sampler: Sampler = point_sample) -> torch.Tensor:
    """Sample the (align-corners, 8x) upsample of `coarse` at fine-pixel
    points, without materializing it and without the x8 magnitude scale.

    coarse [B, h, w, C]; pts [B, N, 2] (x, y) in pixels of the (8h, 8w)
    grid -> [B, N, C] float32."""
    return sampler(coarse, pts, 8)


def advect_up(flows: torch.Tensor, pts: torch.Tensor, is_norm: bool = False,
              sampler: Sampler = point_sample) -> torch.Tensor:
    """Long-range composed flow at fine-pixel points.

    flows [K, B, h, w, 2] coarse per-frame-pair flows (contiguous);
    pts [B, N, 2] fine pixels. Returns [B, N, 2]: pixel units, or normalized
    fine units when is_norm (the flow_cat_norm accumulation)."""
    _, _, h, w, _ = flows.shape
    hf, wf = 8 * h, 8 * w

    def _denorm(gn):
        return torch.stack([(gn[..., 0] + 1.0) * 0.5 * (wf - 1),
                            (gn[..., 1] + 1.0) * 0.5 * (hf - 1)], dim=-1)

    def _norm(p):
        return torch.stack([2.0 * p[..., 0] / (wf - 1) - 1.0,
                            2.0 * p[..., 1] / (hf - 1) - 1.0], dim=-1)

    if is_norm:
        c0 = _norm(pts)
        c = c0
        for f in flows:
            s = sample_up(f, _denorm(c), sampler)
            s = torch.stack([2.0 * (8.0 * s[..., 0]) / (wf - 1),
                             2.0 * (8.0 * s[..., 1]) / (hf - 1)], dim=-1)
            c = c + s
        return c - c0

    p = pts
    for f in flows:
        p = p + 8.0 * sample_up(f, _denorm(_norm(p)), sampler)
    return p - pts


def _taps_1d(p: torch.Tensor, n: int):
    """Bilinear tap coordinates and weights, zeros-padding validity folded
    into the weights."""
    i0 = torch.floor(p)
    a = p - i0
    w0 = torch.where((i0 >= 0.0) & (i0 <= n - 1.0), 1.0 - a, 0.0)
    w1 = torch.where((i0 >= -1.0) & (i0 <= n - 2.0), a, 0.0)
    return i0, i0 + 1.0, w0, w1


def _bilinear_taps(pts: torch.Tensor, hf: int, wf: int):
    """4 tap points [B, N, 4, 2] + weights [B, N, 4] for points [B, N, 2]."""
    x0, x1, wx0, wx1 = _taps_1d(pts[..., 0], wf)
    y0, y1, wy0, wy1 = _taps_1d(pts[..., 1], hf)
    tx = torch.stack([x0, x1, x0, x1], dim=-1)
    ty = torch.stack([y0, y0, y1, y1], dim=-1)
    tw = torch.stack([wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1], dim=-1)
    return torch.stack([tx, ty], dim=-1), tw


def composed_flow_at(flows: torch.Tensor, pts: torch.Tensor, is_norm: bool = False,
                     sampler: Sampler = point_sample) -> torch.Tensor:
    """grid_sample of the composed full-res (pixel-unit) flow at arbitrary
    fine-pixel points, as a 4-tap blend of advected trajectories.
    flows [K, B, h, w, 2]; pts [B, N, 2] -> [B, N, 2] pixels."""
    _, b, h, w, _ = flows.shape
    hf, wf = 8 * h, 8 * w
    tap_pts, tw = _bilinear_taps(pts, hf, wf)
    f = advect_up(flows, tap_pts.reshape(b, -1, 2), is_norm, sampler)
    if is_norm:
        f = f * torch.tensor([(wf - 1) / 2.0, (hf - 1) / 2.0],
                             dtype=f.dtype, device=f.device)
    f = f.reshape(b, -1, 4, 2)
    return torch.sum(f * tw[..., None], dim=2)


def cycle_mask_at(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor,
                  pts: torch.Tensor, alpha_1: float, alpha_2: float,
                  is_norm: bool = False,
                  sampler: Sampler = point_sample) -> torch.Tensor:
    """Full-res forward-backward cycle-consistency mask of the composed
    upsampled fields, at integer fine-pixel points [B, N, 2] -> [B, N] bool."""
    _, b, h, w, _ = flows_fwd.shape
    hf, wf = 8 * h, 8 * w

    def _norm_flow(f):
        return torch.stack([2.0 * f[..., 0] / (wf - 1),
                            2.0 * f[..., 1] / (hf - 1)], dim=-1)

    fwd = advect_up(flows_fwd, pts, is_norm, sampler)
    fwd_n = fwd if is_norm else _norm_flow(fwd)

    c0n = torch.stack([2.0 * pts[..., 0] / (wf - 1) - 1.0,
                       2.0 * pts[..., 1] / (hf - 1) - 1.0], dim=-1)
    c1n = c0n + fwd_n
    in_bounds = (torch.abs(c1n[..., 0]) < 1.0) & (torch.abs(c1n[..., 1]) < 1.0)

    # grid_sample(bwd_composed_n, c1n): 4-tap blend of backward trajectories
    r = torch.stack([(c1n[..., 0] + 1.0) * 0.5 * (wf - 1),
                     (c1n[..., 1] + 1.0) * 0.5 * (hf - 1)], dim=-1)
    tap_pts, tw = _bilinear_taps(r, hf, wf)
    bw = advect_up(flows_bwd, tap_pts.reshape(b, -1, 2), is_norm, sampler)
    bw_n = bw if is_norm else _norm_flow(bw)
    bwd_interp = torch.sum(bw_n.reshape(b, -1, 4, 2) * tw[..., None], dim=2)

    cycle_sq = torch.sum((fwd_n + bwd_interp) ** 2, dim=-1)
    a2 = alpha_2 / math.sqrt(hf * hf + wf * wf)
    eps = alpha_1 * (torch.sum(fwd_n ** 2, dim=-1)
                     + torch.sum(bwd_interp ** 2, dim=-1)) + a2
    return in_bounds & ((cycle_sq - eps) <= 0.0)


@dataclass
class LazyFlowUp:
    """A full-res composed flow (+ cycle mask), represented by its coarse
    flow stack and evaluated on demand at the points the loss reads.

    flows:     [K, B, h, w, 2] flows composing this direction's warp.
    flows_rev: [K, B, h, w, 2] reverse-direction flows (cycle mask), or None.
    sampler:   the U(f) reader, K2's wrapper unless a comparison run swaps it.
    """
    flows: torch.Tensor
    flows_rev: Optional[torch.Tensor] = None
    alpha1: Optional[float] = None
    alpha2: Optional[float] = None
    is_norm: bool = False
    sampler: Sampler = point_sample


def flow_up_warp_points(lf: LazyFlowUp, x: torch.Tensor, y: torch.Tensor,
                        orig_hw) -> tuple:
    """Lazy drop-in for the materialising compose_and_mask(flow_up=True)
    followed by `loss.warp_points_with_flow` on the full-res field + mask.

    x, y [B, ...] points in original-image pixels; orig_hw per-sample
    (H_orig, W_orig) tensors [B]. Returns (x', y', mask_at_points or None)."""
    shp = x.shape
    b = shp[0]
    h_orig, w_orig = orig_hw
    h_orig = h_orig.reshape(b)
    w_orig = w_orig.reshape(b)
    _, _, h, w, _ = lf.flows.shape
    hf, wf = 8 * h, 8 * w

    xo = x.reshape(b, -1)
    yo = y.reshape(b, -1)
    # original-image px -> fine px in warp_points_with_flow's float32 op
    # order (normalize by the original size, denormalize by the fine size)
    gx = 2.0 * xo / (w_orig - 1.0)[:, None] - 1.0
    gy = 2.0 * yo / (h_orig - 1.0)[:, None] - 1.0
    cx = (gx + 1.0) * 0.5 * (wf - 1)
    cy = (gy + 1.0) * 0.5 * (hf - 1)
    pts = torch.stack([cx, cy], dim=-1)

    f = composed_flow_at(lf.flows, pts, lf.is_norm, lf.sampler)
    out_x = xo + f[..., 0] / (wf / w_orig)[:, None]
    out_y = yo + f[..., 1] / (hf / h_orig)[:, None]

    mask_pts = None
    if lf.alpha1 is not None and lf.alpha2 is not None:
        # nearest read of the fine mask field (round half to even, zeros
        # padding), like grid_sample_nearest
        rx = torch.round(cx)
        ry = torch.round(cy)
        valid = (rx >= 0) & (rx <= wf - 1) & (ry >= 0) & (ry <= hf - 1)
        m = cycle_mask_at(lf.flows, lf.flows_rev, torch.stack([rx, ry], dim=-1),
                          lf.alpha1, lf.alpha2, lf.is_norm, lf.sampler)
        mask_pts = (valid & m).reshape(shp)

    return out_x.reshape(shp), out_y.reshape(shp), mask_pts


def mask_ratio_estimate(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor,
                        alpha_1: float, alpha_2: float, is_norm: bool = False,
                        stride: int = 32,
                        sampler: Sampler = point_sample) -> torch.Tensor:
    """Strided estimate of the reference's full-res mask_ratio telemetry
    (fraction of untrusted pixels): the exact cycle mask on every
    `stride`-th fine pixel. Returns [B]."""
    _, b, h, w, _ = flows_fwd.shape
    hf, wf = 8 * h, 8 * w
    dev = flows_fwd.device
    ys = torch.arange(0, hf, stride, dtype=torch.float32, device=dev)
    xs = torch.arange(0, wf, stride, dtype=torch.float32, device=dev)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    pts = pts[None].expand(b, -1, -1)
    m = cycle_mask_at(flows_fwd, flows_bwd, pts, alpha_1, alpha_2, is_norm,
                      sampler)
    return torch.mean((~m).to(torch.float32), dim=-1)
