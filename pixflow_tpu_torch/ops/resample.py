"""Grid resampling with `grid_sample(align_corners=True, padding_mode='zeros')`
semantics, channels-last: the port of `pixflow_tpu/ops/resample.py`.

    images / fields : [B, H, W, C]
    sampling grids  : [B, Hg, Wg, 2] with (x, y) normalized to [-1, 1]
    flows           : [B, H, W, 2] with (fx, fy) in pixels

`grid_sample` is the gather path, in the JAX package's exact float32 op
order. `grid_sample_auto` keeps the JAX package's dispatch by shape: many
points over a small field take `grid_sample_tent`, the port of
`grid_sample_mxu` (tent-weight contractions, x first, then y), and
everything else the gather. The flow algebra (`ops/flow.py`) reads fields
through K2's grid-sample entry (`kernels.grid_sample`), which on the card
launches the kernel in the gather's op order for every shape and on the CPU
takes `grid_sample_auto`, so that CPU runs follow the JAX package on both
sides of the threshold. RAFT's correlation lookup
(`models/raft/corr.py:lookup_corr`) reads its pyramid through the same
entry on the card and through `grid_sample`, the gather, on the CPU, as
the JAX package's `lookup_corr_gather` does. `resize_align_corners` and `upflow8` are two float32
matrix products, as in the JAX package.

Constant divisors are written as products with their float32 reciprocal
(`inv_f32`): XLA compiles the JAX package's jitted `x / n` so, and so does
PyTorch on the card."""

from __future__ import annotations

import functools

import numpy as np
import torch


def inv_f32(n: int) -> float:
    """float32 reciprocal of a constant divisor: `x * inv_f32(n)` is XLA's
    rewrite of `x / n` under jit."""
    return float(np.float32(1.0) / np.float32(n))


def coords_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-coordinate grid [H, W, 2] holding (x, y) at each location."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def normalize_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel coords [..., 2] -> [-1, 1] normalized (align_corners=True)."""
    x = 2.0 * coords[..., 0] * inv_f32(w - 1) - 1.0
    y = 2.0 * coords[..., 1] * inv_f32(h - 1) - 1.0
    return torch.stack([x, y], dim=-1)


def normalize_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel-unit flow -> normalized-unit flow."""
    return torch.stack([2.0 * flow[..., 0] * inv_f32(w - 1),
                        2.0 * flow[..., 1] * inv_f32(h - 1)], dim=-1)


def denormalize_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Normalized-unit flow -> pixel-unit flow (the halving is exact)."""
    return torch.stack([flow[..., 0] * (w - 1) * 0.5,
                        flow[..., 1] * (h - 1) * 0.5], dim=-1)


def _gather_hw(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img[b, yi, xi, :] for per-batch index tensors yi, xi [B, N] (in range)."""
    b, h, w, c = img.shape
    idx = (yi * w + xi).unsqueeze(-1).expand(-1, -1, c)
    return torch.gather(img.reshape(b, h * w, c), 1, idx)


def grid_taps(grid: torch.Tensor, h: int, w: int):
    """The four bilinear taps (x, y, weight, inside) of reads at normalised
    points grid [..., 2] of an h x w field (align_corners=True), in the
    gather's order: (x0, y0), (x1, y0), (x0, y1), (x1, y1). A tap outside
    the field has inside=False. `grid_sample` reads them and the kernels'
    `grid_sample_backward_plain` scatters to them."""
    x = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx = x - x0
    wy = y - y0
    return [(xc, yc, wgt, (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1))
            for xc, yc, wgt in ((x0, y0, (1 - wy) * (1 - wx)),
                                (x1, y0, (1 - wy) * wx),
                                (x0, y1, wy * (1 - wx)),
                                (x1, y1, wy * wx))]


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling, align_corners=True, zeros padding.

    img [B, H, W, C], grid [B, Hg, Wg, 2] -> [B, Hg, Wg, C]."""
    b, h, w, c = img.shape
    gb, gh, gw, _ = grid.shape
    if gb != b:
        raise ValueError(f"batch mismatch {gb} vs {b}")

    out = torch.zeros((b, gh * gw, c), dtype=img.dtype, device=img.device)
    for xc, yc, wgt, valid in grid_taps(grid.reshape(b, gh * gw, 2), h, w):
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


_TENT_CHUNK = 2048  # points a contraction: bounds the weight rows' memory


def grid_sample_tent(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling, align_corners=True, zeros padding, as tent-weight
    contractions: the port of the JAX package's `grid_sample_mxu`. The weight
    of source column i for target x is max(0, 1 - |i - x|), so the dense
    [points, W] and [points, H] weight rows hold exactly the gather's two
    taps; the sum runs over x first, then over y.

    img [B, H, W, C], grid [B, Hg, Wg, 2] -> [B, Hg, Wg, C] float32."""
    b, h, w, c = img.shape
    gb, gh, gw, _ = grid.shape
    if gb != b:
        raise ValueError(f"batch mismatch {gb} vs {b}")
    n = gh * gw
    x = ((grid[..., 0] + 1.0) * 0.5 * (w - 1)).reshape(b, n)
    y = ((grid[..., 1] + 1.0) * 0.5 * (h - 1)).reshape(b, n)
    iw = torch.arange(w, dtype=torch.float32, device=img.device)
    ih = torch.arange(h, dtype=torch.float32, device=img.device)
    # [B, W, H*C]: x is the contracted axis of the first product
    img_x = img.float().permute(0, 2, 1, 3).reshape(b, w, h * c)
    outs = []
    with torch.autocast(img.device.type, enabled=False):
        for s in range(0, n, _TENT_CHUNK):
            xm, ym = x[:, s:s + _TENT_CHUNK], y[:, s:s + _TENT_CHUNK]
            ax = torch.clamp(1.0 - torch.abs(xm[..., None] - iw), min=0.0)  # [B, m, W]
            ay = torch.clamp(1.0 - torch.abs(ym[..., None] - ih), min=0.0)  # [B, m, H]
            t = torch.bmm(ax, img_x).reshape(b, -1, h, c)                   # [B, m, H, C]
            outs.append(torch.einsum("bmy,bmyc->bmc", ay, t))
    return torch.cat(outs, dim=1).reshape(b, gh, gw, c).to(img.dtype)


# the JAX package's dispatch: the tent form pays ~N*(H + W*C) operations, so
# it takes many points over small fields (1/8-res flows), never full-res ones
_TENT_MIN_POINTS = 4096
_TENT_MAX_FIELD = 40960  # source H*W


def grid_sample_auto(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """`grid_sample_tent` for many points over a small field, `grid_sample`
    otherwise, by shape alone, as the JAX package's `grid_sample_auto`."""
    n = grid.shape[1] * grid.shape[2]
    if n >= _TENT_MIN_POINTS and img.shape[1] * img.shape[2] <= _TENT_MAX_FIELD:
        return grid_sample_tent(img, grid)
    return grid_sample(img, grid)


@functools.cache
def _interp_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """Dense 1-D linear-interpolation matrix A [n_out, n_in] with
    align_corners=True source positions src(i) = i * (n_in-1) / (n_out-1):
    two nonzeros a row, computed in float64 and rounded to float32, as the
    JAX package computes it."""
    if n_out == 1:
        a = np.zeros((1, n_in), np.float32)
        a[0, 0] = 1.0
        return a
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    j0 = np.clip(np.floor(src), 0, n_in - 1).astype(np.int64)
    j1 = np.clip(j0 + 1, 0, n_in - 1)
    w1 = (src - j0).astype(np.float32)
    a = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(a, (rows, j0), 1.0 - w1)
    np.add.at(a, (rows, j1), w1)
    return a


def resize_align_corners(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize, align_corners=True (`F.interpolate(mode='bilinear',
    align_corners=True)`'s function), as two float32 matrix products over the
    interpolation matrices. img [B, H, W, C] -> [B, size[0], size[1], C]."""
    b, h, w, c = img.shape
    h2, w2 = size
    if (h, w) == (h2, w2):
        return img
    ah = torch.from_numpy(_interp_matrix_np(h, h2)).to(img.device, img.dtype)
    aw = torch.from_numpy(_interp_matrix_np(w, w2)).to(img.device, img.dtype)
    with torch.autocast(img.device.type, enabled=False):
        out = torch.einsum("oh,bhwc->bowc", ah, img)
        return torch.einsum("pw,bowc->bopc", aw, out)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x upsample of a flow field, values scaled by 8: [B, H, W, 2] ->
    [B, 8H, 8W, 2] (bilinear, align_corners=True)."""
    _, h, w, _ = flow.shape
    return 8.0 * resize_align_corners(flow, (8 * h, 8 * w))
