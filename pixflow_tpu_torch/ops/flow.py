"""Optical-flow field algebra, materialised: long-range composition and the
cycle-consistency mask over whole fields. The port of
`pixflow_tpu/ops/flow.py`.

Conventions:
    flow fields: [..., H, W, 2] channels-last, (fx, fy) in pixel units unless
                 `is_norm=True` says normalized units.
    masks:       [..., H, W] bool, True = flow trusted at that pixel.

Every read of a field at points goes through K2's grid-sample entry
(`kernels.grid_sample`): on the card the kernel, in the gather's float32 op
order; on the CPU the JAX package's shape dispatch (`grid_sample_auto`).
`plain=True` takes that plain dispatch on the card too, for comparison runs.
The JAX package's `lax.scan` over the K flows is a Python loop in the same
order, and its constant divisors are float32 reciprocal products, as XLA
compiles them under jit (`resample.inv_f32`).

This path is the reference's own (`contrast/util.py:174-248`) and the one
the train step takes without the lazy flow_up (`--no-flow_up_lazy`, or
composition at the stored 1/8 resolution without `--flow_up`); the lazy
path (`ops/flow_points.py`) evaluates the same functions at the loss's
points only."""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.flow_up_points import _a2
from .kernels.point_sample import grid_sample as grid_sample_k2
from .resample import (coords_grid, denormalize_flow, grid_sample_auto,
                       normalize_coords, normalize_flow, upflow8)


def _sampler(plain: bool):
    if plain:
        return grid_sample_auto
    return lambda img, grid: grid_sample_k2(img.contiguous(), grid.contiguous())


def concat_flow(flows: torch.Tensor, is_norm: bool = False, upsample8: bool = False,
                plain: bool = False) -> torch.Tensor:
    """Compose K consecutive flows [K, B, h, w, 2] into one long-range flow
    [B, H, W, 2] by advecting a coordinate grid: the k-th flow is sampled at
    the current warped positions and accumulated. `is_norm` composes in
    normalized units (inputs and output normalized); `upsample8` upsamples
    each flow 8x inside the loop, one full-res field live at a time. With
    K == 1 the flow is returned (upsampled, normalized) without a read."""
    k, b, h, w, _ = flows.shape
    if upsample8:
        h, w = 8 * h, 8 * w
    if k == 1:
        out = upflow8(flows[0]) if upsample8 else flows[0]
        return normalize_flow(out, h, w) if is_norm else out

    sample = _sampler(plain)
    base = coords_grid(h, w, flows.dtype, flows.device)[None].expand(b, h, w, 2)
    if is_norm:
        coords0 = normalize_coords(base, h, w)
        coords1 = coords0
        for flow in flows:
            if upsample8:
                flow = upflow8(flow)
            coords1 = coords1 + sample(normalize_flow(flow, h, w), coords1)
        return coords1 - coords0

    coords1 = base
    for flow in flows:
        if upsample8:
            flow = upflow8(flow)
        coords1 = coords1 + sample(flow, normalize_coords(coords1, h, w))
    return coords1 - base


def all_concat_flow(flow_fwds: torch.Tensor, flow_bwds: torch.Tensor,
                    is_norm: bool = False, use_flow_frames: bool = True,
                    upsample8: bool = False, plain: bool = False):
    """Every (span, start) composition of K consecutive flows
    [K, B, h, w, 2], stacked to [S, B, H, W, 2] in `span_windows` order
    (backward windows mirrored); with use_flow_frames=False only the
    full-span composition, as [1, B, H, W, 2]."""
    if not use_flow_frames:
        return (concat_flow(flow_fwds, is_norm, upsample8, plain)[None],
                concat_flow(flow_bwds, is_norm, upsample8, plain)[None])
    k = flow_fwds.shape[0]
    fwd_list, bwd_list = [], []
    for span, s in span_windows(k):
        bwd_end = k - s
        fwd_list.append(concat_flow(flow_fwds[s:s + span], is_norm, upsample8, plain))
        bwd_list.append(concat_flow(flow_bwds[bwd_end - span:bwd_end], is_norm,
                                    upsample8, plain))
    return torch.stack(fwd_list), torch.stack(bwd_list)


def forward_backward_consistency(flow_fwd: torch.Tensor, flow_bwd: torch.Tensor,
                                 alpha_1: float = 0.01, alpha_2: float = 0.5,
                                 is_norm: bool = False, return_cycle: bool = False,
                                 plain: bool = False):
    """Cycle-consistency occlusion mask (arXiv:1711.07837): a pixel is
    trusted iff its forward-warped position lands strictly inside the frame
    and the normalized round-trip residual ||w_f(x) + w_b(x + w_f(x))||^2 is
    at most alpha_1 * (||w_f||^2 + ||w_b_interp||^2) + alpha_2 / sqrt(h^2 +
    w^2). flow_fwd, flow_bwd [B, H, W, 2] -> mask [B, H, W] bool (and the
    normalized cycle residual if return_cycle)."""
    b, h, w, _ = flow_fwd.shape
    if is_norm:
        fwd_n, bwd_n = flow_fwd, flow_bwd
    else:
        fwd_n = normalize_flow(flow_fwd, h, w)
        bwd_n = normalize_flow(flow_bwd, h, w)

    base = coords_grid(h, w, flow_fwd.dtype, flow_fwd.device)[None].expand(b, h, w, 2)
    coords1_n = normalize_coords(base, h, w) + fwd_n
    in_bounds = (torch.abs(coords1_n[..., 0]) < 1.0) & (torch.abs(coords1_n[..., 1]) < 1.0)

    bwd_interp_n = _sampler(plain)(bwd_n, coords1_n)
    cycle_n = fwd_n + bwd_interp_n
    sq = lambda v: v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    eps = alpha_1 * (sq(fwd_n) + sq(bwd_interp_n)) + _a2(alpha_2, h, w)
    mask = in_bounds & ((sq(cycle_n) - eps) <= 0.0)
    if return_cycle:
        return mask, cycle_n
    return mask


def compose_and_mask(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor, *,
                     flow_up: bool = False, use_flow_frames: bool = False,
                     alpha_1: Optional[float] = None, alpha_2: Optional[float] = None,
                     is_norm: bool = False, plain: bool = False):
    """The train step's materialising flow preprocessing: optional 8x
    upsampling, long-range composition and cycle-consistency masks.

    flows_fwd, flows_bwd [B, K, h, w, 2] per-frame-pair flows (1/8-res when
    flow_up). Returns (flow_fwd, flow_bwd, mask_fwd, mask_bwd), flows in
    pixel units:
        use_flow_frames=False -> flows [B, H, W, 2], masks [B, H, W] or None
        use_flow_frames=True  -> flows [S, B, H, W, 2], masks [S, B, H, W]"""
    fwd = flows_fwd.transpose(0, 1)  # [K, B, h, w, 2]
    bwd = flows_bwd.transpose(0, 1)
    fwd_s, bwd_s = all_concat_flow(fwd, bwd, is_norm=is_norm,
                                   use_flow_frames=use_flow_frames,
                                   upsample8=flow_up, plain=plain)

    mask_fwd = mask_bwd = None
    if alpha_1 is not None and alpha_2 is not None:
        mask_fwd = torch.stack([forward_backward_consistency(
            f, bk, alpha_1, alpha_2, is_norm, plain=plain) for f, bk in zip(fwd_s, bwd_s)])
        mask_bwd = torch.stack([forward_backward_consistency(
            bk, f, alpha_1, alpha_2, is_norm, plain=plain) for f, bk in zip(fwd_s, bwd_s)])

    if is_norm:
        hh, ww = fwd_s.shape[-3:-1]
        fwd_s = denormalize_flow(fwd_s, hh, ww)
        bwd_s = denormalize_flow(bwd_s, hh, ww)

    if not use_flow_frames:
        fwd_s, bwd_s = fwd_s[-1], bwd_s[-1]
        if mask_fwd is not None:
            mask_fwd, mask_bwd = mask_fwd[-1], mask_bwd[-1]
    return fwd_s, bwd_s, mask_fwd, mask_bwd


def span_windows(k: int) -> list[tuple[int, int]]:
    """The (length, start) windows of `all_concat_flow`'s stack, span-major,
    start ascending: window i composes forward flows [start, start+length),
    frame `start` -> frame `start+length`."""
    return [(span, s) for span in range(1, k + 1) for s in range(k - span + 1)]


def mask_ratio(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Fraction of untrusted pixels per field ([..., H, W] -> [...])."""
    if mask is None:
        return None
    return torch.mean((~mask).to(torch.float32), dim=(-2, -1))
