"""PixPro loss geometry, the pixel-pair loss and the pixel-propagation
attention: the port of `pixflow_tpu/ops/loss.py` plus the fused pair loss of
`pixflow_tpu/ops/pallas/pair_loss.py:pixpro_pair_loss_fused`.

Crop coordinates are the data pipeline's 10-vector
    [x0/(W-1), y0/(H-1), x1/(W-1), y1/(H-1), j, i, w, h, W, H];
the original-image size is read per sample from columns 8/9.

The train step's pair loss is `pixpro_pair_loss_fused`, whose sums run in the
K1 kernel on the card. `pixpro_pair_loss` is the JAX package's default XLA
composition, kept as the independent reference the fused form is tested
against."""

from __future__ import annotations

from typing import Optional

import torch

from .flow_points import LazyFlowUp, flow_up_warp_points, lazy_warp_points
from .kernels.pair_sums import fused_pair_sums
from .resample import grid_sample, grid_sample_nearest

_NORM_EPS = 1e-12  # torch F.normalize default


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / max(||x||_2, 1e-12)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=_NORM_EPS)


def bin_centers(coord: torch.Tensor, feat_hw: tuple[int, int]):
    """Feature-bin centers in original-image pixels: (x, y), each [B, H, W]."""
    h, w = feat_hw
    xs = (torch.arange(w, dtype=coord.dtype, device=coord.device) + 0.5)[None, None, :]
    ys = (torch.arange(h, dtype=coord.dtype, device=coord.device) + 0.5)[None, :, None]
    bin_w = ((coord[:, 2] - coord[:, 0]) / w)[:, None, None]
    bin_h = ((coord[:, 3] - coord[:, 1]) / h)[:, None, None]
    start_x = coord[:, 0][:, None, None]
    start_y = coord[:, 1][:, None, None]
    w_orig = coord[:, 8][:, None, None]
    h_orig = coord[:, 9][:, None, None]
    x = (xs * bin_w + start_x) * (w_orig - 1.0)
    y = (ys * bin_h + start_y) * (h_orig - 1.0)
    b = coord.shape[0]
    return x.expand(b, h, w), y.expand(b, h, w)


def warp_points_with_flow(flow, x: torch.Tensor, y: torch.Tensor, orig_hw,
                          mask: Optional[torch.Tensor] = None):
    """Advect points by a flow sampled at those points.

    flow [B, Hf, Wf, 2] pixel-unit flow (possibly at another resolution than
    the original image: values are rescaled by Wf / W_orig), or a
    `LazyFlowUp` (then `mask` must be None: it computes its own). x, y
    [B, H, W] original-image pixels; orig_hw per-sample (H_orig, W_orig) [B];
    mask optional [B, Hm, Wm] bool. Returns (x', y', mask_at_points)."""
    if isinstance(flow, LazyFlowUp):
        if mask is not None:
            raise ValueError("LazyFlowUp computes its own cycle mask")
        return flow_up_warp_points(flow, x, y, orig_hw)
    b, hf, wf, _ = flow.shape
    h_orig, w_orig = orig_hw
    h_orig = h_orig.reshape(b, 1, 1)
    w_orig = w_orig.reshape(b, 1, 1)

    gx = 2.0 * x / (w_orig - 1.0) - 1.0
    gy = 2.0 * y / (h_orig - 1.0) - 1.0
    grid = torch.stack([gx, gy], dim=-1)

    f = grid_sample(flow, grid)
    # the ratio divides: a Python number over a tensor would be evaluated
    # as w_orig.reciprocal() * wf
    out_x = x + f[..., 0] / (w_orig.new_full((), wf) / w_orig)
    out_y = y + f[..., 1] / (h_orig.new_full((), hf) / h_orig)

    mask_pts = None
    if mask is not None:
        m = grid_sample_nearest(mask.to(flow.dtype)[..., None], grid)
        mask_pts = m[..., 0] > 0.5
    return out_x, out_y, mask_pts


def _diag(coord: torch.Tensor, h: int, w: int, w_orig, h_orig):
    bw = ((coord[:, 2] - coord[:, 0]) / w)[:, None, None]
    bh = ((coord[:, 3] - coord[:, 1]) / h)[:, None, None]
    return torch.sqrt((bw * (w_orig - 1.0)) ** 2 + (bh * (h_orig - 1.0)) ** 2)


def pair_loss_geometry(coord_q, coord_k, feat_hw: tuple[int, int],
                       pos_ratio: float = 0.5, flow=None, flow_mask=None) -> dict:
    """Positive-pair geometry of `pixpro_pair_loss`: bin centers before
    (`q_x_pre`/`q_y_pre`) and after (`q_x`/`q_y`) the flow warp, the key
    centers (`k_x`/`k_y`), the flow-validity mask at the warped points
    (`mask_pts`) and the positive-pair mask `pos` [B, N, N] bool."""
    h, w = feat_hw
    b = coord_q.shape[0]
    n = h * w
    q_x_pre, q_y_pre = bin_centers(coord_q, (h, w))
    k_x, k_y = bin_centers(coord_k, (h, w))
    w_orig = coord_q[:, 8][:, None, None]
    h_orig = coord_q[:, 9][:, None, None]
    max_diag = torch.maximum(_diag(coord_q, h, w, w_orig, h_orig),
                             _diag(coord_k, h, w, w_orig, h_orig))

    q_x, q_y, mask_pts = q_x_pre, q_y_pre, None
    if flow is not None:
        q_x, q_y, mask_pts = warp_points_with_flow(
            flow, q_x_pre, q_y_pre, (coord_q[:, 9], coord_q[:, 8]), flow_mask)

    dx = q_x.reshape(b, n, 1) - k_x.reshape(b, 1, n)
    dy = q_y.reshape(b, n, 1) - k_y.reshape(b, 1, n)
    dist = torch.sqrt(dx * dx + dy * dy) / max_diag
    pos = dist < pos_ratio
    if mask_pts is not None:
        pos = pos & mask_pts.reshape(b, n, 1)
    return {"q_x_pre": q_x_pre, "q_y_pre": q_y_pre, "q_x": q_x, "q_y": q_y,
            "k_x": k_x, "k_y": k_y, "mask_pts": mask_pts, "pos": pos}


def pixpro_pair_loss(q, k, coord_q, coord_k, pos_ratio: float = 0.5,
                     flow=None, flow_mask=None, reduce: bool = True):
    """Pixel-pair regression loss, XLA-composition form (no kernel).

    q [B, H, W, C] normalized online predictions; k [B, H, W, C] normalized
    targets. Returns (loss, (pos_num [B], pos_mean [B])) with
    loss = -2 * mean_b[ sum(q.k * pos) / (sum(pos) + 1e-6) ]."""
    b, h, w, c = q.shape
    n = h * w
    pos = pair_loss_geometry(coord_q, coord_k, (h, w), pos_ratio,
                             flow, flow_mask)["pos"]
    pos_f = pos.to(torch.float32)
    with torch.autocast(q.device.type, enabled=False):
        logit = torch.bmm(q.reshape(b, n, c).float(),
                          k.reshape(b, n, c).float().transpose(1, 2))
    pos_sum = torch.sum(pos_f, dim=(1, 2))
    per_sample = torch.sum(logit * pos_f, dim=(1, 2)) / (pos_sum + 1e-6)
    loss = -2.0 * (torch.mean(per_sample) if reduce else per_sample)
    return loss, (pos_sum, torch.mean(pos_f, dim=(1, 2)))


def fused_pair_geometry(coord_q, coord_k, feat_hw: tuple[int, int],
                        flow=None, flow_mask=None) -> tuple:
    """K1's geometry inputs, each contiguous: warped query centers qx, qy
    and key centers kx, ky [B, N], inv_diag [B] = 1 / max bin diagonal, and
    the flow-validity mask at the warped points [B, N] float32 (or None)."""
    h, w = feat_hw
    b = coord_q.shape[0]
    n = h * w
    q_x, q_y = bin_centers(coord_q, (h, w))
    k_x, k_y = bin_centers(coord_k, (h, w))
    w_orig = coord_q[:, 8][:, None, None]
    h_orig = coord_q[:, 9][:, None, None]
    inv_diag = (1.0 / torch.maximum(_diag(coord_q, h, w, w_orig, h_orig),
                                    _diag(coord_k, h, w, w_orig, h_orig))).reshape(b)
    pts_mask = None
    orig_hw = (coord_q[:, 9], coord_q[:, 8])
    if isinstance(flow, LazyFlowUp) and flow_mask is None:
        # the fused kernel writes K1's layout: [B, N] float32, contiguous
        q_x, q_y, pts_mask = lazy_warp_points(flow, q_x, q_y, orig_hw)
    elif flow is not None:
        q_x, q_y, m = warp_points_with_flow(flow, q_x, q_y, orig_hw, flow_mask)
        if m is not None:
            pts_mask = m.reshape(b, n).to(torch.float32)
    flat = lambda t: t.reshape(b, n).contiguous()
    return (flat(q_x), flat(q_y), flat(k_x), flat(k_y), inv_diag.contiguous(),
            pts_mask)


def pixpro_pair_loss_fused(q, k, coord_q, coord_k, pos_ratio: float = 0.5,
                           flow=None, flow_mask=None, plain: bool = False):
    """The pair loss over K1 (`kernels.fused_pair_sums`), same signature and
    return contract as `pixpro_pair_loss`. The mask uses the kernel's
    `dist * inv_diag < pos_ratio`; the mask sum is a constant of the
    gradient (stop-gradient in the denominator). `plain=True` takes K1's
    plain versions, forward and backward, for a comparison run."""
    b, h, w, c = q.shape
    n = h * w
    geometry = fused_pair_geometry(coord_q, coord_k, (h, w), flow, flow_mask)
    sums = fused_pair_sums(q.reshape(b, n, c).contiguous(),
                           k.reshape(b, n, c).contiguous(),
                           *geometry, pos_ratio, plain)
    pos_sum = sums[:, 1].detach()
    per_sample = sums[:, 0] / (pos_sum + 1e-6)
    loss = -2.0 * torch.mean(per_sample)
    return loss, (pos_sum, pos_sum / (n * n))


def ppm_attention(feat: torch.Tensor, value: torch.Tensor, p: float = 1.0,
                  clamp_value: float = 0.0) -> torch.Tensor:
    """Pixel propagation: A = clamp(f^T f, min=clamp_value) ** p over
    normalized features, returns sum_j A[i, j] v_j. feat, value [B, H, W, C]."""
    b, h, w, c = feat.shape
    n = h * w
    f = l2_normalize(feat).reshape(b, n, c)
    v = l2_normalize(value).reshape(b, n, c)
    att = torch.bmm(f, f.transpose(1, 2))
    att = torch.clamp(att, min=clamp_value)
    if p < 1.0:
        att = att + 1e-6
    if p != 1.0:
        att = att ** p
    att = att.to(v.dtype)
    out = torch.bmm(att, v)
    return out.to(feat.dtype).reshape(b, h, w, c)


def instance_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """BYOL instance loss -2 * mean(<x, y>) over normalized [B, C] vectors."""
    return -2.0 * torch.mean(torch.sum(x * y, dim=-1))
