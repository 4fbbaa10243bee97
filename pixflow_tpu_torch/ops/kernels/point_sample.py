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
and two contractions."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

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
