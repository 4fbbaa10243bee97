"""Grid resampling with `grid_sample(align_corners=True, padding_mode='zeros')`
semantics, channels-last: the port of `pixflow_tpu/ops/resample.py`.

    images / fields : [B, H, W, C]
    sampling grids  : [B, Hg, Wg, 2] with (x, y) normalized to [-1, 1]
    flows           : [B, H, W, 2] with (fx, fy) in pixels

The JAX package's MXU formulations (`grid_sample_mxu`, `grid_sample_auto`)
are TPU-specific and have no counterpart here: this is the gather path, in
the JAX package's exact float32 op order."""

from __future__ import annotations

import torch


def coords_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-coordinate grid [H, W, 2] holding (x, y) at each location."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def normalize_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel coords [..., 2] -> [-1, 1] normalized (align_corners=True)."""
    x = 2.0 * coords[..., 0] / (w - 1) - 1.0
    y = 2.0 * coords[..., 1] / (h - 1) - 1.0
    return torch.stack([x, y], dim=-1)


def normalize_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel-unit flow -> normalized-unit flow."""
    return torch.stack([2.0 * flow[..., 0] / (w - 1),
                        2.0 * flow[..., 1] / (h - 1)], dim=-1)


def denormalize_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Normalized-unit flow -> pixel-unit flow."""
    return torch.stack([flow[..., 0] * (w - 1) / 2.0,
                        flow[..., 1] * (h - 1) / 2.0], dim=-1)


def _gather_hw(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img[b, yi, xi, :] for per-batch index tensors yi, xi [B, N] (in range)."""
    b, h, w, c = img.shape
    idx = (yi * w + xi).unsqueeze(-1).expand(-1, -1, c)
    return torch.gather(img.reshape(b, h * w, c), 1, idx)


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling, align_corners=True, zeros padding.

    img [B, H, W, C], grid [B, Hg, Wg, 2] -> [B, Hg, Wg, C]."""
    b, h, w, c = img.shape
    gb, gh, gw, _ = grid.shape
    if gb != b:
        raise ValueError(f"batch mismatch {gb} vs {b}")

    x = ((grid[..., 0] + 1.0) * 0.5 * (w - 1)).reshape(b, gh * gw)
    y = ((grid[..., 1] + 1.0) * 0.5 * (h - 1)).reshape(b, gh * gw)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx = x - x0
    wy = y - y0

    out = torch.zeros((b, gh * gw, c), dtype=img.dtype, device=img.device)
    for yc, xc, wgt in ((y0, x0, (1 - wy) * (1 - wx)),
                        (y0, x1, (1 - wy) * wx),
                        (y1, x0, wy * (1 - wx)),
                        (y1, x1, wy * wx)):
        valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        xi = torch.clamp(xc, 0, w - 1).to(torch.int64)
        yi = torch.clamp(yc, 0, h - 1).to(torch.int64)
        tap = _gather_hw(img, yi, xi)
        out = out + torch.where(valid[..., None], wgt[..., None] * tap,
                                torch.zeros((), dtype=tap.dtype, device=tap.device))
    return out.reshape(b, gh, gw, c)


def grid_sample_nearest(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Nearest sampling, align_corners=True, zeros padding; rounds half to
    even (`torch.round`, like `jnp.round` and torch's nearest mode)."""
    b, h, w, c = img.shape
    gb, gh, gw, _ = grid.shape
    if gb != b:
        raise ValueError(f"batch mismatch {gb} vs {b}")

    x = torch.round((grid[..., 0] + 1.0) * 0.5 * (w - 1)).reshape(b, gh * gw)
    y = torch.round((grid[..., 1] + 1.0) * 0.5 * (h - 1)).reshape(b, gh * gw)
    valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    xi = torch.clamp(x, 0, w - 1).to(torch.int64)
    yi = torch.clamp(y, 0, h - 1).to(torch.int64)
    tap = _gather_hw(img, yi, xi)
    out = torch.where(valid[..., None], tap,
                      torch.zeros((), dtype=tap.dtype, device=tap.device))
    return out.reshape(b, gh, gw, c)
