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

The composition itself (`advect_up`, `composed_flow_at`, `cycle_mask_at`)
lives beside its kernel in `kernels/flow_up_points.py`, as that kernel's
plain version. On the card one launch of that kernel evaluates a whole
direction (`flow_up_warp_points`), and one more the telemetry's strided
mask (`mask_ratio_estimate`); `LazyFlowUp.plain` and `plain=True` send a
comparison run through the plain composition instead. `sample_up` is the
K2 primitive (`kernels/point_sample.py`, `up=8`), kept for the tests."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .kernels.flow_up_points import (advect_up, composed_flow_at, cycle_mask_at,
                                     cycle_mask_points, cycle_mask_points_plain,
                                     flow_up_points, flow_up_points_plain)
from .kernels.point_sample import composite_weights_1d, point_sample

__all__ = ["LazyFlowUp", "advect_up", "composed_flow_at", "composite_weights_1d",
           "cycle_mask_at", "flow_up_warp_points", "lazy_warp_points",
           "mask_grid", "mask_ratio_estimate", "sample_up"]


def sample_up(coarse: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample the (align-corners, 8x) upsample of `coarse` at fine-pixel
    points, without materializing it and without the x8 magnitude scale.

    coarse [B, h, w, C]; pts [B, N, 2] (x, y) in pixels of the (8h, 8w)
    grid -> [B, N, C] float32."""
    return point_sample(coarse, pts, 8)


@dataclass
class LazyFlowUp:
    """A full-res composed flow (+ cycle mask), represented by its coarse
    flow stack and evaluated on demand at the points the loss reads.

    flows:     [K, B, h, w, 2] flows composing this direction's warp.
    flows_rev: [K, B, h, w, 2] reverse-direction flows (cycle mask), or None.
    plain:     evaluate through the plain composition even on the card (a
               comparison run); otherwise the fused kernel's wrapper decides.
    """
    flows: torch.Tensor
    flows_rev: Optional[torch.Tensor] = None
    alpha1: Optional[float] = None
    alpha2: Optional[float] = None
    is_norm: bool = False
    plain: bool = False


def lazy_warp_points(lf: LazyFlowUp, x: torch.Tensor, y: torch.Tensor,
                     orig_hw) -> tuple:
    """`flow_up_warp_points` in K1's input layout: x, y [B, ...] points in
    original-image pixels, orig_hw per-sample (H_orig, W_orig) [B]. Returns
    (x', y' [B, N] float32, mask [B, N] float32 or None), contiguous."""
    b = x.shape[0]
    h_orig, w_orig = orig_hw
    masked = lf.alpha1 is not None and lf.alpha2 is not None
    if masked and lf.flows_rev is None:
        raise ValueError("LazyFlowUp: a cycle mask (alpha1, alpha2) needs flows_rev")
    fn = flow_up_points_plain if lf.plain else flow_up_points
    return fn(lf.flows, lf.flows_rev if masked else None,
              x.reshape(b, -1).contiguous(), y.reshape(b, -1).contiguous(),
              w_orig.reshape(b), h_orig.reshape(b), lf.alpha1, lf.alpha2,
              lf.is_norm)


def flow_up_warp_points(lf: LazyFlowUp, x: torch.Tensor, y: torch.Tensor,
                        orig_hw) -> tuple:
    """Lazy drop-in for the materialising compose_and_mask(flow_up=True)
    followed by `loss.warp_points_with_flow` on the full-res field + mask.

    x, y [B, ...] points in original-image pixels; orig_hw per-sample
    (H_orig, W_orig) tensors [B]. Returns (x', y', mask_at_points bool or
    None), each shaped like x."""
    shp = x.shape
    out_x, out_y, m = lazy_warp_points(lf, x, y, orig_hw)
    return (out_x.reshape(shp), out_y.reshape(shp),
            None if m is None else (m != 0.0).reshape(shp))


def mask_ratio_estimate(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor,
                        alpha_1: float, alpha_2: float, is_norm: bool = False,
                        stride: int = 32, plain: bool = False) -> torch.Tensor:
    """Strided estimate of the reference's full-res mask_ratio telemetry
    (fraction of untrusted pixels): the exact cycle mask on every
    `stride`-th fine pixel. Returns [B]."""
    _, b, h, w, _ = flows_fwd.shape
    pts = mask_grid(b, h, w, stride, flows_fwd.device)
    fn = cycle_mask_points_plain if plain else cycle_mask_points
    m = fn(flows_fwd, flows_bwd, pts, alpha_1, alpha_2, is_norm)
    return torch.mean(1.0 - m, dim=-1)


def mask_grid(b: int, h: int, w: int, stride: int, device) -> torch.Tensor:
    """Every `stride`-th pixel of the (8h, 8w) fine grid, x fastest, as
    points [b, N, 2] float32 (contiguous, the same for every sample)."""
    ys = torch.arange(0, 8 * h, stride, dtype=torch.float32, device=device)
    xs = torch.arange(0, 8 * w, stride, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    return pts[None].expand(b, -1, -1).contiguous()
