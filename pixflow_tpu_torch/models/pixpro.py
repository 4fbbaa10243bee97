"""PixPro: online + momentum branches and the symmetric pixel-pair loss. The
port of `pixflow_tpu/models/pixpro.py` (reference `contrast/models/PixPro.py`).

One `nn.Module` holds both branches side by side (`encoder`, `projector`,
`value_transform`, `encoder_k`, `projector_k`, ...). The momentum branch is
updated only by `ema_update`, which the train step applies with the
pre-step online weights before the key forward; it runs under `no_grad`,
with its BatchNorm in train mode, like the reference's never-eval'd key
encoder.

`dtype=torch.bfloat16` runs both branches under `torch.autocast(bfloat16)`
over float32 weights (the recipes' compute dtype); the loss, its geometry
and the lazy flow evaluation always run in float32."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.loss import l2_normalize, pixpro_pair_loss_fused, ppm_attention
from .heads import MLP2d, dense
from .resnet import make_resnet

# online-branch module -> momentum-branch module
EMA_PAIRS = (
    ("encoder", "encoder_k"),
    ("projector", "projector_k"),
)


def momentum_schedule(k: int, total_steps: int, base_momentum: float) -> float:
    """Cosine-ramped EMA momentum 1 - (1-m) * (cos(pi*k/K)+1)/2, evaluated in
    float32 like the JAX package. Starts at `base_momentum`, ends at 1."""
    f32 = np.float32
    ramp = (np.cos(f32(math.pi) * f32(k) / f32(total_steps)) + f32(1.0)) / f32(2.0)
    return float(f32(1.0) - f32(1.0 - base_momentum) * ramp)


def _ema_pairs(model: nn.Module):
    for q_name, k_name in EMA_PAIRS:
        q, k = getattr(model, q_name, None), getattr(model, k_name, None)
        if q is not None and k is not None:
            yield list(q.parameters()), list(k.parameters())


@torch.no_grad()
def ema_update(model: nn.Module, momentum: float) -> None:
    """In place: k = k * m + q * (1 - m) for every EMA pair of `model`."""
    for qp, kp in _ema_pairs(model):
        torch._foreach_mul_(kp, momentum)
        torch._foreach_add_(kp, torch._foreach_mul(qp, 1.0 - momentum))


@torch.no_grad()
def init_momentum_from_online(model: nn.Module) -> None:
    """Copy the online weights into their momentum twins (init time only)."""
    for qp, kp in _ema_pairs(model):
        torch._foreach_copy_(kp, qp)


class PixPro(nn.Module):
    """Online encoder -> projector -> PPM, momentum encoder -> projector."""

    def __init__(self, arch: str = "resnet50", pixpro_p: float = 1.0,
                 pixpro_clamp_value: float = 0.0, pixpro_transform_layer: int = 0,
                 pixpro_pos_ratio: float = 0.7, pixpro_ins_loss_weight: float = 0.0,
                 proj_inner_dim: int = 4096, proj_out_dim: int = 256,
                 dtype: torch.dtype = torch.float32, bn_momentum: float = 0.9,
                 fuse_views: bool = False,
                 generator: Optional[torch.Generator] = None, group=None):
        super().__init__()
        if pixpro_ins_loss_weight > 0.0:
            raise NotImplementedError("the instance-loss heads are not ported yet "
                                      "(every recipe has pixpro_ins_loss_weight=0)")
        self.pixpro_p = pixpro_p
        self.pixpro_clamp_value = pixpro_clamp_value
        self.pixpro_pos_ratio = pixpro_pos_ratio
        self.dtype = dtype
        # both views as ONE 2B pass per branch, BatchNorm statistics per view
        self.fuse_views = fuse_views
        # `group`: every BatchNorm of both branches averages its statistics
        # over the ranks (the JAX modules' `axis_name`)
        common = dict(view_groups=2 if fuse_views else 1, bn_momentum=bn_momentum,
                      generator=generator, group=group)

        self.encoder = make_resnet(arch, **common)
        feat = self.encoder.feature_dim
        self.projector = MLP2d(feat, proj_inner_dim, proj_out_dim, **common)
        self.encoder_k = make_resnet(arch, **common)
        self.projector_k = MLP2d(feat, proj_inner_dim, proj_out_dim, **common)

        if pixpro_transform_layer == 0:
            self.value_transform = None
        elif pixpro_transform_layer == 1:
            self.value_transform = dense(proj_out_dim, proj_out_dim, generator)
        elif pixpro_transform_layer == 2:
            self.value_transform = MLP2d(proj_out_dim, proj_out_dim, proj_out_dim,
                                         **common)
        else:
            raise NotImplementedError(
                f"pixpro_transform_layer={pixpro_transform_layer}")

    # --- branch forwards -------------------------------------------------

    def featprop(self, proj: torch.Tensor) -> torch.Tensor:
        """Pixel propagation: value transform + cosine-attention smoothing."""
        value = proj if self.value_transform is None else self.value_transform(proj)
        return ppm_attention(proj, value, p=self.pixpro_p,
                             clamp_value=self.pixpro_clamp_value)

    def online(self, im: torch.Tensor) -> torch.Tensor:
        """-> normalized pixel predictions [B, h, w, C]."""
        return l2_normalize(self.featprop(self.projector(self.encoder(im))))

    def momentum_branch(self, im: torch.Tensor) -> torch.Tensor:
        """-> normalized projections (the targets); the caller stops gradients."""
        return l2_normalize(self.projector_k(self.encoder_k(im)))

    # --- multi-span loss (use_flow_frames) -------------------------------

    def multi_span_loss(self, ims1, ims2, coords1, coords2, flows_fwd, flows_bwd,
                        masks_fwd, masks_bwd, spans, n_frames_eff, plain: bool = False):
        """The loss over every (span, start) window of the frame stack: window
        (length l, start s) pairs the view-1 crop of frame s with the view-2
        crop of frame s+l, warped by that window's flow; each sample averages
        its pair losses over the windows its real frame count reaches.

        ims1 [B, F, H, W, 3] view-1 crops of frames 0..F-1 (F = n_frames-1);
        ims2 [B, F, H, W, 3] view-2 crops of frames 1..F; coords1/coords2
        [B, F, 10]; flows_fwd/flows_bwd a list of S `LazyFlowUp`s or dense
        [S, B, h, w, 2] fields, masks None or [S, B, h, w], all in `spans`
        order (`ops.flow.span_windows`); n_frames_eff [B] real frame counts.
        The pair losses run through K1 (`plain=True`: its plain versions).
        Returns (loss, stats), stats per sample over its valid windows."""
        b, f = ims1.shape[:2]
        flat = lambda x: x.reshape((b * f,) + x.shape[2:])
        unflat = lambda x: x.reshape((b, f) + x.shape[1:])
        dev = ims1.device.type
        with torch.autocast(dev, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            if self.fuse_views:
                both = torch.cat([flat(ims1), flat(ims2)], dim=0)
                pred_1, pred_2 = self.online(both).chunk(2)
                with torch.no_grad():
                    proj_1_ng, proj_2_ng = self.momentum_branch(both).chunk(2)
            else:
                pred_1, pred_2 = self.online(flat(ims1)), self.online(flat(ims2))
                with torch.no_grad():
                    proj_1_ng = self.momentum_branch(flat(ims1))
                    proj_2_ng = self.momentum_branch(flat(ims2))
        pred_1, pred_2 = unflat(pred_1), unflat(pred_2)
        proj_1_ng, proj_2_ng = unflat(proj_1_ng), unflat(proj_2_ng)

        eff = n_frames_eff.to(torch.float32)
        zeros = lambda: torch.zeros((b,), dtype=torch.float32, device=ims1.device)
        loss_1, loss_2, weight = zeros(), zeros(), zeros()
        pos_num_1, pos_num_2, pos_mean_1, pos_mean_2 = zeros(), zeros(), zeros(), zeros()
        with torch.autocast(dev, enabled=False):
            for i, (length, s) in enumerate(spans):
                e = s + length  # target frame index
                valid = (e <= (eff - 1.0)).to(torch.float32)
                l1, (pn1, pm1) = pixpro_pair_loss_fused(
                    pred_1[:, s], proj_2_ng[:, e - 1], coords1[:, s], coords2[:, e - 1],
                    self.pixpro_pos_ratio, flow=flows_fwd[i],
                    flow_mask=None if masks_fwd is None else masks_fwd[i],
                    plain=plain, reduce=False)
                l2, (pn2, pm2) = pixpro_pair_loss_fused(
                    pred_2[:, e - 1], proj_1_ng[:, s], coords2[:, e - 1], coords1[:, s],
                    self.pixpro_pos_ratio, flow=flows_bwd[i],
                    flow_mask=None if masks_bwd is None else masks_bwd[i],
                    plain=plain, reduce=False)
                loss_1 = loss_1 + valid * l1
                loss_2 = loss_2 + valid * l2
                weight = weight + valid
                pos_num_1 = pos_num_1 + valid * pn1
                pos_num_2 = pos_num_2 + valid * pn2
                pos_mean_1 = pos_mean_1 + valid * pm1
                pos_mean_2 = pos_mean_2 + valid * pm2

        denom = torch.clamp(weight, min=1.0)
        loss = torch.mean((loss_1 + loss_2) / denom)
        stats = {"pos_num_1": pos_num_1 / denom, "pos_mean_1": pos_mean_1 / denom,
                 "pos_num_2": pos_num_2 / denom, "pos_mean_2": pos_mean_2 / denom}
        return loss, stats

    # --- full loss (both views) ------------------------------------------

    def forward(self, im1, im2, coord1, coord2, flow_fwd=None, flow_bwd=None,
                mask_fwd=None, mask_bwd=None, plain: bool = False):
        """Symmetric PixPro loss over the two views; a flow (dense field or
        `LazyFlowUp`) warps each query grid onto the other view. `plain=True`
        takes K1's plain versions, forward and backward, for a comparison
        run. Returns (loss, stats)."""
        dev = im1.device.type
        with torch.autocast(dev, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            if self.fuse_views:
                both = torch.cat([im1, im2], dim=0)
                pred_1, pred_2 = self.online(both).chunk(2)
                with torch.no_grad():
                    proj_1_ng, proj_2_ng = self.momentum_branch(both).chunk(2)
            else:
                pred_1, pred_2 = self.online(im1), self.online(im2)
                with torch.no_grad():
                    proj_1_ng = self.momentum_branch(im1)
                    proj_2_ng = self.momentum_branch(im2)

        with torch.autocast(dev, enabled=False):
            loss_1, (pos_num_1, pos_mean_1) = pixpro_pair_loss_fused(
                pred_1, proj_2_ng, coord1, coord2, self.pixpro_pos_ratio,
                flow=flow_fwd, flow_mask=mask_fwd, plain=plain)
            loss_2, (pos_num_2, pos_mean_2) = pixpro_pair_loss_fused(
                pred_2, proj_1_ng, coord2, coord1, self.pixpro_pos_ratio,
                flow=flow_bwd, flow_mask=mask_bwd, plain=plain)
        stats = {"pos_num_1": pos_num_1, "pos_mean_1": pos_mean_1,
                 "pos_num_2": pos_num_2, "pos_mean_2": pos_mean_2}
        return loss_1 + loss_2, stats
