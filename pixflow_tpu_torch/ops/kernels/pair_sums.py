"""K1: fused per-sample pixel-pair sums. Port of the TPU kernel
`pixflow_tpu/ops/pallas/pair_loss.py:_pair_kernel` (`_pair_sums_pallas`,
wrapped by the custom VJP `fused_pair_sums`); the CUDA source is
`csrc/pair_sums.cu`.

For each sample b, with M the positive-pair mask

    M_ij = (sqrt(dx_ij^2 + dy_ij^2) * inv_diag[b] < pos_ratio) * pts_mask[b, i]

between warped query bin centers (qx, qy) and key centers (kx, ky), returns
[B, 2] = (sum_ij (q_i . k_j) M_ij, sum_ij M_ij), in float32.

`pair_sums` launches the forward kernel for CUDA tensors and takes
`pair_sums_plain` for CPU tensors. `fused_pair_sums` is the differentiable
form: its backward recomputes M in PyTorch and returns dq = (g M) k and
dk = (g M)^T q, as the JAX package's `_bwd` leaves to XLA; the geometry
inputs get no gradient."""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from .build import c_function


def pair_mask(qx, qy, kx, ky, inv_diag, pts_mask, pos_ratio: float) -> torch.Tensor:
    """M [B, N, N] float32, in the TPU kernel's float32 op order."""
    dx = qx[:, :, None] - kx[:, None, :]
    dy = qy[:, :, None] - ky[:, None, :]
    dist = torch.sqrt(dx * dx + dy * dy) * inv_diag[:, None, None]
    mask = (dist < pos_ratio).to(torch.float32)
    if pts_mask is not None:
        mask = mask * pts_mask.to(torch.float32)[:, :, None]
    return mask


def pair_sums_plain(q, k, qx, qy, kx, ky, inv_diag, pts_mask,
                    pos_ratio: float) -> torch.Tensor:
    """Plain PyTorch version: [B, 2] = (sum(q k^T * M), sum(M))."""
    mask = pair_mask(qx, qy, kx, ky, inv_diag, pts_mask, pos_ratio)
    with torch.autocast(q.device.type, enabled=False):  # full f32
        logit = torch.bmm(q.float(), k.float().transpose(1, 2))
    return torch.stack([(logit * mask).sum(dim=(1, 2)), mask.sum(dim=(1, 2))],
                       dim=1)


@functools.cache
def _kernel():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return c_function("pixflow_pair_sums",
                      [vp] * 9 + [ci, ci, ci, ctypes.c_float, ci, vp])


def pair_sums(q, k, qx, qy, kx, ky, inv_diag, pts_mask,
              pos_ratio: float) -> torch.Tensor:
    """K1's forward wrapper. q, k [B, N, C] bf16 or f32; qx, qy, kx, ky
    [B, N] f32; inv_diag [B] f32; pts_mask [B, N] f32 or None; all
    contiguous. Returns [B, 2] float32."""
    if q.device.type == "cpu":
        return pair_sums_plain(q, k, qx, qy, kx, ky, inv_diag, pts_mask, pos_ratio)
    geometry = [qx, qy, kx, ky, inv_diag] + ([] if pts_mask is None else [pts_mask])
    tensors = [q, k] + geometry
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("pair_sums: every input must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype:
        raise ValueError(f"pair_sums takes f32 or bf16 q/k of one dtype "
                         f"(got {q.dtype}, {k.dtype})")
    if any(t.dtype != torch.float32 for t in geometry):
        raise ValueError("pair_sums takes float32 centers, inv_diag and mask")
    b, n, c = q.shape
    if k.shape != q.shape or inv_diag.shape != (b,) \
            or any(t.shape != (b, n) for t in geometry if t is not inv_diag):
        raise ValueError(f"pair_sums shapes: q/k {tuple(q.shape)}, {tuple(k.shape)} "
                         f"must be [B,N,C], centers/mask [B,N], inv_diag [B]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pair_sums takes contiguous tensors")
    out = torch.empty((b, 2), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    rc = _kernel()(q.data_ptr(), k.data_ptr(), qx.data_ptr(), qy.data_ptr(),
                   kx.data_ptr(), ky.data_ptr(), inv_diag.data_ptr(),
                   None if pts_mask is None else pts_mask.data_ptr(),
                   out.data_ptr(), b, n, c, float(pos_ratio),
                   int(q.dtype == torch.bfloat16),
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pair_sums kernel launch failed (cudaError {rc})")
    pair_sums.launches += 1
    return out


pair_sums.launches = 0


class _FusedPairSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, qx, qy, kx, ky, inv_diag, pts_mask, pos_ratio, sums_fn):
        ctx.save_for_backward(q, k, qx, qy, kx, ky, inv_diag, pts_mask)
        ctx.pos_ratio = pos_ratio
        return sums_fn(q, k, qx, qy, kx, ky, inv_diag, pts_mask, pos_ratio)

    @staticmethod
    def backward(ctx, g):
        q, k, qx, qy, kx, ky, inv_diag, pts_mask = ctx.saved_tensors
        mask = pair_mask(qx, qy, kx, ky, inv_diag, pts_mask, ctx.pos_ratio)
        gm = g[:, 0, None, None].float() * mask  # cotangent of the logit sum
        with torch.autocast(q.device.type, enabled=False):
            dq = torch.bmm(gm, k.float())
            dk = torch.bmm(gm.transpose(1, 2), q.float())
        return (dq.to(q.dtype), dk.to(k.dtype)) + (None,) * 8


def fused_pair_sums(q, k, qx, qy, kx, ky, inv_diag,
                    pts_mask: Optional[torch.Tensor], pos_ratio: float,
                    sums_fn: Callable = pair_sums) -> torch.Tensor:
    """Differentiable (masked logit sum, mask sum) [B, 2]. `sums_fn` is the
    forward: the K1 wrapper, or `pair_sums_plain` for a comparison run."""
    return _FusedPairSums.apply(q, k, qx, qy, kx, ky, inv_diag, pts_mask,
                                float(pos_ratio), sums_fn)
