"""The lazy flow_up evaluation of one direction in one launch: the H100
redesign of K2's use on the train step's path (CUDA source
`csrc/flow_up_points.cu`), with its plain version, the JAX package's
point-domain composition (`pixflow_tpu/ops/flow_points.py`).

    flow_up_points(flows, flows_rev, x, y, w_orig, h_orig, ...)
        -> out_x, out_y [B, N], mask [B, N] float32 (1.0 = trusted) or None

is `flow_up_warp_points` in K1's input layout: the query points x, y [B, N]
(original-image pixels) warped by the composed full-res flow, and the
full-res cycle mask read at them. `cycle_mask_points(flows, flows_rev, pts,
...)` is the cycle mask alone at fine points [B, N, 2] (`mask_ratio_estimate`).
Both wrappers launch the kernel for CUDA tensors, take the plain versions
for CPU tensors, and count their launches on `flow_up_points.launches`.

Numerics. The lazy composition amplifies ulp-level position differences
chaotically, so the plain version fixes every float32 op order and the
kernel repeats it: the normalise -> denormalise round trips of the
materialising path, tap blends as ascending adds, and a division by a
constant as a multiplication by its float32 reciprocal (`_inv`), which is
what XLA compiles the JAX package's jitted step to. A division by data (the
original image size) is a true division."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from .build import c_function
from .point_sample import _scale, point_sample_plain

Sampler = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _inv(n: int) -> float:
    """float32 reciprocal of a constant divisor: `x * _inv(n)` is XLA's
    rewrite of `x / n` under jit."""
    return float(np.float32(1.0) / np.float32(n))


def _a2(alpha_2: float, hf: int, wf: int) -> float:
    """The cycle test's additive threshold, rounded to float32 as a Python
    constant is rounded where it meets a float32 tensor."""
    return float(np.float32(alpha_2 / math.sqrt(hf * hf + wf * wf)))


def sample_up_plain(coarse: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """U(f) read of the plain composition: the align-corners 8x upsample of
    `coarse` [B, h, w, C] at fine points [B, N, 2], no magnitude scale."""
    return point_sample_plain(coarse, pts, 8)


def advect_up(flows: torch.Tensor, pts: torch.Tensor, is_norm: bool = False,
              sampler: Sampler = sample_up_plain) -> torch.Tensor:
    """Long-range composed flow at fine-pixel points.

    flows [K, B, h, w, 2] coarse per-frame-pair flows; pts [B, N, 2] fine
    pixels. Returns [B, N, 2]: pixel units, or normalized fine units when
    is_norm (the flow_cat_norm accumulation). `sampler` reads U(f); a
    measurement may wrap it."""
    _, _, h, w, _ = flows.shape
    iw, ih = _inv(8 * w - 1), _inv(8 * h - 1)

    def _denorm(gn):
        return torch.stack([(gn[..., 0] + 1.0) * 0.5 * (8 * w - 1),
                            (gn[..., 1] + 1.0) * 0.5 * (8 * h - 1)], dim=-1)

    def _norm(p):
        return torch.stack([2.0 * p[..., 0] * iw - 1.0,
                            2.0 * p[..., 1] * ih - 1.0], dim=-1)

    if is_norm:
        c0 = _norm(pts)
        c = c0
        for f in flows:
            s = sampler(f, _denorm(c))
            c = c + torch.stack([2.0 * (8.0 * s[..., 0]) * iw,
                                 2.0 * (8.0 * s[..., 1]) * ih], dim=-1)
        return c - c0

    p = pts
    for f in flows:
        p = p + 8.0 * sampler(f, _denorm(_norm(p)))
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


def _blend4(v: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """sum_t v[:, :, t] * tw[..., t] as ((t0 + t1) + t2) + t3, the kernel's
    order. v [B, N, 4, 2], tw [B, N, 4] -> [B, N, 2]."""
    p = v * tw[..., None]
    return p[:, :, 0] + p[:, :, 1] + p[:, :, 2] + p[:, :, 3]


def composed_flow_at(flows: torch.Tensor, pts: torch.Tensor, is_norm: bool = False,
                     sampler: Sampler = sample_up_plain) -> torch.Tensor:
    """grid_sample of the composed full-res (pixel-unit) flow at arbitrary
    fine-pixel points, as a 4-tap blend of advected trajectories.
    flows [K, B, h, w, 2]; pts [B, N, 2] -> [B, N, 2] pixels."""
    _, b, h, w, _ = flows.shape
    hf, wf = 8 * h, 8 * w
    tap_pts, tw = _bilinear_taps(pts, hf, wf)
    f = advect_up(flows, tap_pts.reshape(b, -1, 2), is_norm, sampler)
    if is_norm:
        f = torch.stack([f[..., 0] * ((wf - 1) / 2.0),
                         f[..., 1] * ((hf - 1) / 2.0)], dim=-1)
    return _blend4(f.reshape(b, -1, 4, 2), tw)


def cycle_mask_at(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor,
                  pts: torch.Tensor, alpha_1: float, alpha_2: float,
                  is_norm: bool = False,
                  sampler: Sampler = sample_up_plain) -> torch.Tensor:
    """Full-res forward-backward cycle-consistency mask of the composed
    upsampled fields, at integer fine-pixel points [B, N, 2] -> [B, N] bool."""
    _, b, h, w, _ = flows_fwd.shape
    hf, wf = 8 * h, 8 * w
    iw, ih = _inv(wf - 1), _inv(hf - 1)

    def _norm_flow(f):
        return torch.stack([2.0 * f[..., 0] * iw, 2.0 * f[..., 1] * ih], dim=-1)

    fwd = advect_up(flows_fwd, pts, is_norm, sampler)
    fwd_n = fwd if is_norm else _norm_flow(fwd)

    c0n = torch.stack([2.0 * pts[..., 0] * iw - 1.0,
                       2.0 * pts[..., 1] * ih - 1.0], dim=-1)
    c1n = c0n + fwd_n
    in_bounds = (torch.abs(c1n[..., 0]) < 1.0) & (torch.abs(c1n[..., 1]) < 1.0)

    # grid_sample(bwd_composed_n, c1n): 4-tap blend of backward trajectories
    r = torch.stack([(c1n[..., 0] + 1.0) * 0.5 * (wf - 1),
                     (c1n[..., 1] + 1.0) * 0.5 * (hf - 1)], dim=-1)
    tap_pts, tw = _bilinear_taps(r, hf, wf)
    bw = advect_up(flows_bwd, tap_pts.reshape(b, -1, 2), is_norm, sampler)
    bw_n = bw if is_norm else _norm_flow(bw)
    bwd_interp = _blend4(bw_n.reshape(b, -1, 4, 2), tw)

    sq = lambda v: v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    cycle_sq = sq(fwd_n + bwd_interp)
    eps = alpha_1 * (sq(fwd_n) + sq(bwd_interp)) + _a2(alpha_2, hf, wf)
    return in_bounds & ((cycle_sq - eps) <= 0.0)


def flow_up_points_plain(flows, flows_rev, x, y, w_orig, h_orig,
                         alpha1: Optional[float] = None,
                         alpha2: Optional[float] = None, is_norm: bool = False,
                         sampler: Sampler = sample_up_plain) -> tuple:
    """Plain version of `flow_up_points`: the composition above, op by op.

    flows [K, B, h, w, 2]; flows_rev the same or None (no mask); x, y [B, N]
    original-image pixels; w_orig, h_orig [B]. Returns (out_x, out_y [B, N],
    mask [B, N] float32 or None)."""
    _, b, h, w, _ = flows.shape
    hf, wf = 8 * h, 8 * w
    w_orig = w_orig.reshape(b, 1)
    h_orig = h_orig.reshape(b, 1)
    # original-image px -> fine px in warp_points_with_flow's float32 op
    # order (normalize by the original size, denormalize by the fine size)
    gx = 2.0 * x / (w_orig - 1.0) - 1.0
    gy = 2.0 * y / (h_orig - 1.0) - 1.0
    cx = (gx + 1.0) * 0.5 * (wf - 1)
    cy = (gy + 1.0) * 0.5 * (hf - 1)

    f = composed_flow_at(flows, torch.stack([cx, cy], dim=-1), is_norm, sampler)
    # the ratio wf / w_orig divides too: a Python number over a tensor would
    # be evaluated as w_orig.reciprocal() * wf
    out_x = x + f[..., 0] / (w_orig.new_full((), wf) / w_orig)
    out_y = y + f[..., 1] / (h_orig.new_full((), hf) / h_orig)
    if flows_rev is None:
        return out_x, out_y, None

    # nearest read of the fine mask field (round half to even, zeros
    # padding), like grid_sample_nearest
    rx = torch.round(cx)
    ry = torch.round(cy)
    valid = (rx >= 0) & (rx <= wf - 1) & (ry >= 0) & (ry <= hf - 1)
    m = cycle_mask_at(flows, flows_rev, torch.stack([rx, ry], dim=-1),
                      alpha1, alpha2, is_norm, sampler)
    return out_x, out_y, (valid & m).to(torch.float32)


def cycle_mask_points_plain(flows, flows_rev, pts, alpha1: float, alpha2: float,
                            is_norm: bool = False,
                            sampler: Sampler = sample_up_plain) -> torch.Tensor:
    """Plain version of `cycle_mask_points`: [B, N] float32, 1.0 = trusted."""
    return cycle_mask_at(flows, flows_rev, pts, alpha1, alpha2, is_norm,
                         sampler).to(torch.float32)


@functools.cache
def _kernel(name: str):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "pixflow_flow_up_points":
        args = [vp] * 6 + [ci] + [vp] * 3 + [ci] * 5 + [cf] * 4 + [ci, vp]
    else:
        args = [vp] * 4 + [ci] * 5 + [cf] * 4 + [ci, vp]
    return c_function(name, args)


def _check_flows(fn: str, flows, flows_rev, tensors) -> None:
    if flows.device.type != "cuda" or any(t.device != flows.device for t in tensors):
        raise ValueError(f"{fn}: every input must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{fn} takes float32 tensors")
    if flows.dim() != 5 or flows.shape[-1] != 2 or \
            (flows_rev is not None and flows_rev.shape != flows.shape):
        raise ValueError(f"{fn}: flows {tuple(flows.shape)} must be [K,B,h,w,2], "
                         f"flows_rev the same or None")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn} takes contiguous tensors")
    if flows.data_ptr() % 8 or (flows_rev is not None and flows_rev.data_ptr() % 8):
        raise ValueError(f"{fn}: flows must be 8-byte aligned (float2 loads)")
    if flows.numel() >= 2 ** 31:
        raise ValueError(f"{fn}: flows too large for 32-bit offsets")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flow_up_points(flows, flows_rev, x, y, w_orig, h_orig,
                   alpha1: Optional[float] = None, alpha2: Optional[float] = None,
                   is_norm: bool = False) -> tuple:
    """The fused kernel's wrapper (warp mode): the CUDA kernel for CUDA
    tensors, `flow_up_points_plain` for CPU tensors. flows [K, B, h, w, 2]
    float32 contiguous; flows_rev the same, or None for no mask (alpha1 and
    alpha2 are then unused); x, y [B, N] float32 contiguous; w_orig, h_orig
    [B] float32, any stride. Returns (out_x, out_y, mask or None), each
    [B, N] float32 contiguous."""
    if flows.device.type == "cpu":
        return flow_up_points_plain(flows, flows_rev, x, y, w_orig, h_orig,
                                    alpha1, alpha2, is_norm)
    masked = flows_rev is not None
    _check_flows("flow_up_points", flows, flows_rev,
                 [flows, x, y] + ([flows_rev] if masked else []))
    if w_orig.device != flows.device or h_orig.device != flows.device or \
            w_orig.dtype != torch.float32 or h_orig.dtype != torch.float32:
        raise ValueError("flow_up_points: w_orig, h_orig must be float32 on the flows' device")
    k, b, h, w, _ = flows.shape
    if x.dim() != 2 or x.shape[0] != b or y.shape != x.shape or \
            w_orig.shape != (b,) or h_orig.shape != (b,) or \
            w_orig.stride() != h_orig.stride():
        raise ValueError(f"flow_up_points shapes: x, y {tuple(x.shape)}, {tuple(y.shape)} "
                         f"must be [B,N] with B={b}; w_orig, h_orig [B] of one stride")
    if masked and (alpha1 is None or alpha2 is None):
        raise ValueError("flow_up_points: a cycle mask needs alpha1 and alpha2")
    n = x.shape[1]
    if 8 * b * n >= 2 ** 31:
        raise ValueError("flow_up_points: too many points for 32-bit indices")
    out_x, out_y = torch.empty_like(x), torch.empty_like(x)
    mask = torch.empty_like(x) if masked else None
    if x.numel() == 0:
        return out_x, out_y, mask
    rc = _kernel("pixflow_flow_up_points")(
        flows.data_ptr(), flows_rev.data_ptr() if masked else None,
        x.data_ptr(), y.data_ptr(), w_orig.data_ptr(), h_orig.data_ptr(),
        w_orig.stride(0), out_x.data_ptr(), out_y.data_ptr(),
        mask.data_ptr() if masked else None, k, b, n, h, w,
        _scale(8 * h, h), _scale(8 * w, w),
        float(alpha1) if masked else 0.0,
        _a2(alpha2, 8 * h, 8 * w) if masked else 0.0, int(is_norm), _stream(x))
    if rc != 0:
        raise RuntimeError(f"flow_up_points kernel launch failed (cudaError {rc})")
    flow_up_points.launches += 1
    return out_x, out_y, mask


flow_up_points.launches = 0


def cycle_mask_points(flows, flows_rev, pts, alpha1: float, alpha2: float,
                      is_norm: bool = False) -> torch.Tensor:
    """The fused kernel's wrapper in mask mode: the cycle mask at fine
    points pts [B, N, 2] float32 contiguous -> [B, N] float32 (1.0 =
    trusted). Counts on `flow_up_points.launches`."""
    if flows.device.type == "cpu":
        return cycle_mask_points_plain(flows, flows_rev, pts, alpha1, alpha2, is_norm)
    if flows_rev is None:
        raise ValueError("cycle_mask_points needs the reverse flows")
    _check_flows("cycle_mask_points", flows, flows_rev, [flows, flows_rev, pts])
    k, b, h, w, _ = flows.shape
    if pts.dim() != 3 or pts.shape[0] != b or pts.shape[-1] != 2:
        raise ValueError(f"cycle_mask_points: pts {tuple(pts.shape)} must be [B,N,2] "
                         f"with B={b}")
    if pts.data_ptr() % 8:
        raise ValueError("cycle_mask_points: pts must be 8-byte aligned (float2 loads)")
    n = pts.shape[1]
    if 4 * b * n >= 2 ** 31:
        raise ValueError("cycle_mask_points: too many points for 32-bit indices")
    mask = torch.empty((b, n), dtype=torch.float32, device=pts.device)
    if mask.numel() == 0:
        return mask
    rc = _kernel("pixflow_cycle_mask_points")(
        flows.data_ptr(), flows_rev.data_ptr(), pts.data_ptr(), mask.data_ptr(),
        k, b, n, h, w, _scale(8 * h, h), _scale(8 * w, w), float(alpha1),
        _a2(alpha2, 8 * h, 8 * w), int(is_norm), _stream(pts))
    if rc != 0:
        raise RuntimeError(f"cycle_mask_points kernel launch failed (cudaError {rc})")
    flow_up_points.launches += 1
    return mask
