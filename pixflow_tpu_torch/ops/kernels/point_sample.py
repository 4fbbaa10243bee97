"""K2: sampling a coarse field, or its align-corners `up`x upsample, at
points. Port of the TPU kernel `pixflow_tpu/ops/pallas/warp.py:_warp_kernel`
(`tent_warp_pallas`), whose CUDA source is `csrc/point_sample.cu`.

    point_sample(field, pts, up)[b, n, c] = U_up(field)[b](pts[b, n])[c]

with U_up the align-corners `up`x upsample of the coarse field and the read
bilinear, align_corners=True, zeros padding. `up=1` is `tent_warp_pallas`;
`up=8` is `flow_points.sample_up` (no x8 magnitude scale).

`point_sample` launches the kernel for a CUDA tensor and takes the plain
version, `point_sample_plain`, for a CPU tensor. The plain version is the
JAX package's own formulation: dense composite weights over the coarse axes
and two contractions.

    grid_sample(img, grid)[b, i, j, c] = bilinear read of img[b] at grid[b, i, j]

is K2's grid-sample entry (`tent_warp_pallas`'s function at a normalised
grid), a second kernel of the same source. Its callers: the materialising
flow algebra (`ops/flow.py`), and RAFT's correlation lookup
(`models/raft/corr.py:lookup_corr`: [B*H*W, h_l, w_l, 1] pyramid levels
read at (2r+1)^2 window points each, 4 levels an iteration). On the card it reads in the gather's op order and
gives `resample.grid_sample`'s bits; on the CPU it takes
`resample.grid_sample_auto`, the JAX package's dispatch by shape (the tent
contractions for many points over a small field, which sum in another
order, else the gather). It counts on `grid_sample.launches`.

    grid_sample_backward(grad_out, grid, img_shape) = d<grad_out, grid_sample(img, grid)>/d img

is the gradient of that entry with respect to the field, a kernel of its
own (`csrc/grid_sample_bwd.cu`, counted on `grid_sample_backward.launches`);
its plain version `grid_sample_backward_plain` scatters the four taps with
`index_add_` in the plain gather's tap order. `grid_sample_with_grad` binds
the two as one `torch.autograd.Function` for RAFT's training
(`models/raft/corr.py`): its forward is `grid_sample`, bit for bit, and it
refuses a grid that requires a gradient (RAFT detaches its coordinates)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..resample import grid_sample_auto, grid_taps
from .build import c_function


def _scale(n_fine: int, n_coarse: int) -> float:
    """Align-corners source step (n_coarse-1)/(n_fine-1), rounded to float32
    as JAX rounds the weak-typed Python constant."""
    return 0.0 if n_fine == 1 else float(np.float32((n_coarse - 1) / (n_fine - 1)))


def composite_weights_1d(p: torch.Tensor, n_fine: int, n_coarse: int) -> torch.Tensor:
    """Weights w [..., n_coarse] such that `w @ f` is the bilinear
    (zeros-padded) sample, at fine coordinate `p`, of the align-corners
    (n_coarse -> n_fine) upsample of the 1-D signal f. With
    n_coarse == n_fine this is the plain two-tap bilinear weight row."""
    i0 = torch.floor(p)
    a = p - i0
    v0 = (i0 >= 0.0) & (i0 <= n_fine - 1.0)
    v1 = (i0 >= -1.0) & (i0 <= n_fine - 2.0)
    scale = _scale(n_fine, n_coarse)
    s0 = i0 * scale
    s1 = (i0 + 1.0) * scale
    j = torch.arange(n_coarse, dtype=p.dtype, device=p.device)
    t0 = torch.clamp(1.0 - torch.abs(s0[..., None] - j), min=0.0)
    t1 = torch.clamp(1.0 - torch.abs(s1[..., None] - j), min=0.0)
    w0 = torch.where(v0[..., None], (1.0 - a)[..., None] * t0, 0.0)
    w1 = torch.where(v1[..., None], a[..., None] * t1, 0.0)
    return w0 + w1


def point_sample_plain(field: torch.Tensor, pts: torch.Tensor, up: int = 1) -> torch.Tensor:
    """Plain PyTorch version: field [B, H, W, C], pts [B, N, 2] (x, y) in
    pixels of the (up*H, up*W) grid -> [B, N, C] float32."""
    b, h, w, _ = field.shape
    wy = composite_weights_1d(pts[..., 1], up * h, h)  # [B, N, H]
    wx = composite_weights_1d(pts[..., 0], up * w, w)  # [B, N, W]
    with torch.autocast(field.device.type, enabled=False):  # full f32
        t = torch.einsum("bny,byxc->bnxc", wy, field.float())
        return torch.einsum("bnx,bnxc->bnc", wx, t)


@functools.cache
def _kernel():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return c_function("pixflow_point_sample",
                      [vp, vp, vp, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, ctypes.c_float, vp])


def point_sample(field: torch.Tensor, pts: torch.Tensor, up: int = 1) -> torch.Tensor:
    """K2's wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. field [B, H, W, C] float32, pts [B, N, 2] float32, both
    contiguous; returns [B, N, C] float32."""
    if field.device.type == "cpu":
        return point_sample_plain(field, pts, up)
    if field.device.type != "cuda" or pts.device != field.device:
        raise ValueError(f"point_sample: field on {field.device}, points on "
                         f"{pts.device}; both must be on one CUDA device")
    if field.dtype != torch.float32 or pts.dtype != torch.float32:
        raise ValueError(f"point_sample takes float32 (got {field.dtype}, {pts.dtype})")
    if field.dim() != 4 or pts.dim() != 3 or pts.shape[-1] != 2 \
            or pts.shape[0] != field.shape[0]:
        raise ValueError(f"point_sample shapes: field {tuple(field.shape)} "
                         f"must be [B,H,W,C], points {tuple(pts.shape)} [B,N,2]")
    if not (field.is_contiguous() and pts.is_contiguous()):
        raise ValueError("point_sample takes contiguous tensors")
    if up < 1:
        raise ValueError(f"point_sample: up={up} must be >= 1")
    b, h, w, c = field.shape
    n = pts.shape[1]
    if field.numel() >= 2 ** 31 or b * n * max(c, 2) >= 2 ** 31:
        raise ValueError("point_sample: too large for the kernel's 32-bit offsets")
    out = torch.empty((b, n, c), dtype=torch.float32, device=field.device)
    if out.numel() == 0:
        return out
    rc = _kernel()(field.data_ptr(), pts.data_ptr(), out.data_ptr(),
                   b, h, w, c, n, up, _scale(up * h, h), _scale(up * w, w),
                   torch.cuda.current_stream(field.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"point_sample kernel launch failed (cudaError {rc})")
    point_sample.launches += 1
    return out


point_sample.launches = 0


@functools.cache
def _grid_kernel():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return c_function("pixflow_grid_sample", [vp, vp, vp, ci, ci, ci, ci, ci, vp])


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """K2's grid-sample entry: the CUDA kernel for CUDA tensors,
    `resample.grid_sample_auto` for CPU tensors. img [B, H, W, C] float32,
    grid [B, Hg, Wg, 2] float32 normalised (x, y), both contiguous and
    8-byte aligned; returns [B, Hg, Wg, C] float32 (bilinear,
    align_corners=True, zeros padding)."""
    if img.device.type == "cpu":
        return grid_sample_auto(img, grid)
    if img.device.type != "cuda" or grid.device != img.device:
        raise ValueError(f"grid_sample: img on {img.device}, grid on {grid.device}; "
                         f"both must be on one CUDA device")
    if img.dtype != torch.float32 or grid.dtype != torch.float32:
        raise ValueError(f"grid_sample takes float32 (got {img.dtype}, {grid.dtype})")
    if img.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2 \
            or grid.shape[0] != img.shape[0]:
        raise ValueError(f"grid_sample shapes: img {tuple(img.shape)} must be "
                         f"[B,H,W,C], grid {tuple(grid.shape)} [B,Hg,Wg,2]")
    if not (img.is_contiguous() and grid.is_contiguous()):
        raise ValueError("grid_sample takes contiguous tensors")
    if grid.data_ptr() % 8:
        raise ValueError("grid_sample: the grid must be 8-byte aligned (float2 loads)")
    b, h, w, c = img.shape
    _, gh, gw, _ = grid.shape
    n = gh * gw
    if img.numel() >= 2 ** 31 or b * n * max(c, 2) >= 2 ** 31:
        raise ValueError("grid_sample: too large for the kernel's 32-bit offsets")
    out = torch.empty((b, gh, gw, c), dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    rc = _grid_kernel()(img.data_ptr(), grid.data_ptr(), out.data_ptr(), b, h, w, c, n,
                        torch.cuda.current_stream(img.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grid_sample kernel launch failed (cudaError {rc})")
    grid_sample.launches += 1
    return out


grid_sample.launches = 0


def grid_sample_backward_plain(grad_out: torch.Tensor, grid: torch.Tensor,
                               img_shape) -> torch.Tensor:
    """Plain PyTorch version of the entry's field gradient: grad_out
    [B, Hg, Wg, C], grid [B, Hg, Wg, 2] -> grad_img `img_shape` = [B, H, W, C]
    float32. Each tap's term, weight * grad_out, is added with `index_add_`
    at its texel, tap by tap in the plain gather's order
    (`ops/resample.py:grid_sample`); a tap outside the field adds nothing."""
    b, h, w, c = img_shape
    gb, gh, gw, _ = grid.shape
    if gb != b or tuple(grad_out.shape) != (b, gh, gw, c):
        raise ValueError(f"grid_sample_backward_plain shapes: grad_out "
                         f"{tuple(grad_out.shape)}, grid {tuple(grid.shape)}, "
                         f"img {tuple(img_shape)}")
    g = grad_out.reshape(b, gh * gw, c).float()
    base = (torch.arange(b, device=grid.device) * (h * w))[:, None]
    out = torch.zeros((b * h * w, c), dtype=torch.float32, device=grid.device)
    for xc, yc, wgt, valid in grid_taps(grid.reshape(b, gh * gw, 2), h, w):
        idx = base + torch.clamp(yc, 0, h - 1).to(torch.int64) * w \
            + torch.clamp(xc, 0, w - 1).to(torch.int64)
        term = torch.where(valid[..., None], wgt[..., None] * g,
                           torch.zeros((), dtype=g.dtype, device=g.device))
        out.index_add_(0, idx.reshape(-1), term.reshape(-1, c))
    return out.reshape(b, h, w, c)


@functools.cache
def _grid_bwd_kernel():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return c_function("pixflow_grid_sample_bwd", [vp, vp, vp, ci, ci, ci, ci, ci, vp])


# an H100 block's shared memory (227 KB) holds at least one row of the
# gradient field, 32 floats and a byte a texel of scratch
_SHARED_FLOATS = 232448 // 4


def _bwd_row_floats(h: int, w: int, c: int) -> int:
    return h * w * c + 32 + (h * w + 3) // 4


def grid_sample_backward(grad_out: torch.Tensor, grid: torch.Tensor,
                         img_shape) -> torch.Tensor:
    """The gradient of `grid_sample(img, grid)` with respect to img, given
    grad_out [B, Hg, Wg, C]: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. grad_out and grid float32 (grad_out is made
    contiguous: it arrives from reshape and cat backward), img_shape
    [B, H, W, C]; returns [B, H, W, C] float32."""
    if grid.device.type == "cpu":
        return grid_sample_backward_plain(grad_out, grid, img_shape)
    if grid.device.type != "cuda" or grad_out.device != grid.device:
        raise ValueError(f"grid_sample_backward: grad_out on {grad_out.device}, grid on "
                         f"{grid.device}; both must be on one CUDA device")
    if grad_out.dtype != torch.float32 or grid.dtype != torch.float32:
        raise ValueError(f"grid_sample_backward takes float32 (got {grad_out.dtype}, "
                         f"{grid.dtype})")
    b, h, w, c = (int(v) for v in img_shape)
    if grid.dim() != 4 or grid.shape[-1] != 2 or grid.shape[0] != b \
            or tuple(grad_out.shape) != (b, grid.shape[1], grid.shape[2], c):
        raise ValueError(f"grid_sample_backward shapes: grad_out {tuple(grad_out.shape)} "
                         f"must be [B,Hg,Wg,C], grid {tuple(grid.shape)} [B,Hg,Wg,2], "
                         f"img {(b, h, w, c)}")
    if not grid.is_contiguous() or grid.data_ptr() % 8:
        raise ValueError("grid_sample_backward: the grid must be contiguous and 8-byte "
                         "aligned (float2 loads)")
    grad_out = grad_out.contiguous()
    n = grid.shape[1] * grid.shape[2]
    if b * h * w * c >= 2 ** 31 or b * n * max(c, 2) >= 2 ** 31:
        raise ValueError("grid_sample_backward: too large for the kernel's 32-bit offsets")
    if _bwd_row_floats(h, w, c) > _SHARED_FLOATS:
        raise ValueError(f"grid_sample_backward: a row of {h}x{w}x{c} floats does not fit "
                         f"a block's shared memory")
    grad_img = torch.empty((b, h, w, c), dtype=torch.float32, device=grid.device)
    if grad_img.numel() == 0:
        return grad_img
    rc = _grid_bwd_kernel()(grad_out.data_ptr(), grid.data_ptr(), grad_img.data_ptr(),
                            b, h, w, c, n, torch.cuda.current_stream(grid.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grid_sample_backward kernel launch failed (cudaError {rc})")
    grid_sample_backward.launches += 1
    return grad_img


grid_sample_backward.launches = 0


class _GridSampleFn(torch.autograd.Function):
    """grid_sample's forward; the field's gradient through
    `grid_sample_backward`; none for the grid."""

    @staticmethod
    def forward(ctx, img, grid):
        ctx.save_for_backward(grid)
        ctx.img_shape = tuple(img.shape)
        return grid_sample(img, grid)

    @staticmethod
    def backward(ctx, grad_out):
        (grid,) = ctx.saved_tensors
        return grid_sample_backward(grad_out, grid, ctx.img_shape), None


def grid_sample_with_grad(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """`grid_sample(img, grid)` with a gradient for img: the grid-sample
    entry forward and `grid_sample_backward` backward on the card. Raises
    when the grid requires a gradient, which neither kernel computes."""
    if grid.requires_grad:
        raise ValueError("grid_sample_with_grad: no gradient for the grid (detach the "
                         "sampling coordinates, as RAFT does every iteration)")
    return _GridSampleFn.apply(img, grid)
