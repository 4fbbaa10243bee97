"""K1: fused per-sample pixel-pair sums and their backward. Port of the TPU
kernel `pixflow_tpu/ops/pallas/pair_loss.py:_pair_kernel` (`_pair_sums_pallas`,
wrapped by the custom VJP `fused_pair_sums`) and of that VJP's `_bwd`; the
CUDA sources are `csrc/pair_sums.cu` (forward) and `csrc/pair_sums_bwd.cu`
(backward).

For each sample b, with M the positive-pair mask

    M_ij = (sqrt(dx_ij^2 + dy_ij^2) * inv_diag[b] < pos_ratio) * pts_mask[b, i]

between warped query bin centers (qx, qy) and key centers (kx, ky), the
forward returns [B, 2] = (sum_ij (q_i . k_j) M_ij, sum_ij M_ij), in float32,
and the backward, for the cotangent g [B] of the logit sums, returns
dq = g (M k) and dk = g (M^T q), each only when asked for.

`pair_sums` and `pair_sums_backward` launch their kernels for CUDA tensors
and take `pair_sums_plain` / `pair_sums_backward_plain` for CPU tensors.
`fused_pair_sums` is the differentiable form; the geometry inputs get no
gradient, and `dk` is computed only when `k` requires one."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

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


def pair_sums_backward_plain(q, k, qx, qy, kx, ky, inv_diag, pts_mask, g,
                             pos_ratio: float, need_dq: bool = True,
                             need_dk: bool = True) -> tuple:
    """Plain PyTorch version of the backward, as the JAX package's `_bwd`:
    (dq, dk) = ((g M) k, (g M)^T q) in f32, cast to the inputs' dtype; each
    is None unless asked for."""
    mask = pair_mask(qx, qy, kx, ky, inv_diag, pts_mask, pos_ratio)
    gm = g.float()[:, None, None] * mask  # cotangent of the logit matrix
    with torch.autocast(q.device.type, enabled=False):
        dq = torch.bmm(gm, k.float()).to(q.dtype) if need_dq else None
        dk = torch.bmm(gm.transpose(1, 2), q.float()).to(k.dtype) if need_dk else None
    return dq, dk


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, qx, qy, kx, ky, inv_diag, pts_mask, out; B, N, C, pos_ratio, is_bf16, stream
    "pixflow_pair_sums": [_VP] * 9 + [_CI, _CI, _CI, _CF, _CI, _VP],
    # q, k, qx, qy, kx, ky, inv_diag, pts_mask, g; g_stride; dq, dk; B, N, C,
    # pos_ratio, is_bf16, stream
    "pixflow_pair_sums_bwd": [_VP] * 9 + [_CI, _VP, _VP, _CI, _CI, _CI, _CF, _CI, _VP],
}


@functools.cache
def _kernel(name: str):
    return c_function(name, _SIGNATURES[name])


def _check(fn: str, q, k, qx, qy, kx, ky, inv_diag, pts_mask) -> None:
    """Raises ValueError on inputs the kernels do not take."""
    geometry = [qx, qy, kx, ky, inv_diag] + ([] if pts_mask is None else [pts_mask])
    tensors = [q, k] + geometry
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{fn}: every input must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype:
        raise ValueError(f"{fn} takes f32 or bf16 q/k of one dtype "
                         f"(got {q.dtype}, {k.dtype})")
    if any(t.dtype != torch.float32 for t in geometry):
        raise ValueError(f"{fn} takes float32 centers, inv_diag and mask")
    b, n, c = q.shape
    if k.shape != q.shape or inv_diag.shape != (b,) \
            or any(t.shape != (b, n) for t in geometry if t is not inv_diag):
        raise ValueError(f"{fn} shapes: q/k {tuple(q.shape)}, {tuple(k.shape)} "
                         f"must be [B,N,C], centers/mask [B,N], inv_diag [B]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn} takes contiguous tensors")
    if b > 65535 or b * n >= 2 ** 31:
        raise ValueError(f"{fn}: at most 65535 samples and 2^31 - 1 rows")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pair_sums(q, k, qx, qy, kx, ky, inv_diag, pts_mask,
              pos_ratio: float) -> torch.Tensor:
    """K1's forward wrapper. q, k [B, N, C] bf16 or f32; qx, qy, kx, ky
    [B, N] f32; inv_diag [B] f32; pts_mask [B, N] f32 or None; all
    contiguous. Returns [B, 2] float32."""
    if q.device.type == "cpu":
        return pair_sums_plain(q, k, qx, qy, kx, ky, inv_diag, pts_mask, pos_ratio)
    _check("pair_sums", q, k, qx, qy, kx, ky, inv_diag, pts_mask)
    b, n, c = q.shape
    out = torch.empty((b, 2), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    rc = _kernel("pixflow_pair_sums")(
        q.data_ptr(), k.data_ptr(), qx.data_ptr(), qy.data_ptr(), kx.data_ptr(),
        ky.data_ptr(), inv_diag.data_ptr(),
        None if pts_mask is None else pts_mask.data_ptr(), out.data_ptr(), b, n, c,
        float(pos_ratio), int(q.dtype == torch.bfloat16), _stream(q))
    if rc != 0:
        raise RuntimeError(f"pair_sums kernel launch failed (cudaError {rc})")
    pair_sums.launches += 1
    return out


pair_sums.launches = 0


def pair_sums_backward(q, k, qx, qy, kx, ky, inv_diag, pts_mask, g,
                       pos_ratio: float, need_dq: bool = True,
                       need_dk: bool = True) -> tuple:
    """K1's backward wrapper. Inputs as `pair_sums`, and g [B] float32 (any
    stride), the cotangent of the logit sums. Returns (dq, dk) [B, N, C] in
    q's dtype, each None unless asked for; one launch computes both."""
    if q.device.type == "cpu":
        return pair_sums_backward_plain(q, k, qx, qy, kx, ky, inv_diag, pts_mask, g,
                                        pos_ratio, need_dq, need_dk)
    _check("pair_sums_backward", q, k, qx, qy, kx, ky, inv_diag, pts_mask)
    b, n, c = q.shape
    if g.device != q.device or g.dtype != torch.float32 or g.shape != (b,):
        raise ValueError(f"pair_sums_backward: g must be [B] float32 on q's device "
                         f"(got {tuple(g.shape)} {g.dtype} on {g.device})")
    dq = torch.empty_like(q) if need_dq else None
    dk = torch.empty_like(k) if need_dk else None
    if not (need_dq or need_dk) or q.numel() == 0:
        return dq, dk
    rc = _kernel("pixflow_pair_sums_bwd")(
        q.data_ptr(), k.data_ptr(), qx.data_ptr(), qy.data_ptr(), kx.data_ptr(),
        ky.data_ptr(), inv_diag.data_ptr(),
        None if pts_mask is None else pts_mask.data_ptr(), g.data_ptr(), g.stride(0),
        None if dq is None else dq.data_ptr(), None if dk is None else dk.data_ptr(),
        b, n, c, float(pos_ratio), int(q.dtype == torch.bfloat16), _stream(q))
    if rc != 0:
        raise RuntimeError(f"pair_sums_backward kernel launch failed (cudaError {rc})")
    pair_sums_backward.launches += 1
    return dq, dk


pair_sums_backward.launches = 0


class _FusedPairSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, qx, qy, kx, ky, inv_diag, pts_mask, pos_ratio, plain):
        ctx.save_for_backward(q, k, qx, qy, kx, ky, inv_diag, pts_mask)
        ctx.pos_ratio, ctx.plain = pos_ratio, plain
        forward = pair_sums_plain if plain else pair_sums
        return forward(q, k, qx, qy, kx, ky, inv_diag, pts_mask, pos_ratio)

    @staticmethod
    def backward(ctx, g):
        need_dq, need_dk = ctx.needs_input_grad[:2]
        backward = pair_sums_backward_plain if ctx.plain else pair_sums_backward
        # the mask sum (column 1) gets no gradient
        dq, dk = backward(*ctx.saved_tensors, g[:, 0], ctx.pos_ratio, need_dq, need_dk)
        return (dq, dk) + (None,) * 8


def fused_pair_sums(q, k, qx, qy, kx, ky, inv_diag,
                    pts_mask: Optional[torch.Tensor], pos_ratio: float,
                    plain: bool = False) -> torch.Tensor:
    """Differentiable (masked logit sum, mask sum) [B, 2]. Forward and
    backward go through K1's two wrappers; `plain=True` takes both plain
    versions instead, for a comparison run on the card."""
    return _FusedPairSums.apply(q, k, qx, qy, kx, ky, inv_diag, pts_mask,
                                float(pos_ratio), plain)
