"""The RAFT optical-flow network: the port of
`pixflow_tpu/models/raft/raft.py` (the reference's vendored
`contrast/flow/raft.py`). Small (hidden/context 96/64, radius 3) and basic
(128/128, radius 4), a 4-level all-pairs correlation pyramid, GRU
refinement with the coordinates detached every iteration
(`raft.py:140-141`), convex upsampling for basic and `upflow8` for small.

Images and flows are channels-last at the public functions, as in the JAX
package: images [B, H, W, 3] in [0, 255], flows [B, h, w, 2]. Inside,
convolutions run on NCHW tensors. Pretraining uses RAFT as a frozen flow
oracle (reference `main_pretrain.py:55-57`); `train/raft_trainer.py`
trains it, the gradient reaching the correlation pyramid through the
lookup's backward (`corr.py`) and never the detached coordinates."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resample import coords_grid, inv_f32, upflow8
from .corr import build_corr_pyramid, lookup_corr
from .extractor import Encoder
from .update import BasicUpdateBlock, SmallUpdateBlock


def convex_upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsampling (reference `raft.py:85-96`).

    flow [B, H, W, 2]; mask [B, H, W, 64*9], channels laid out (9, 8, 8) as
    the reference's view. A softmax over the 9 taps weighs the 3x3
    neighbourhood of 8*flow, taken in (dy, dx) raster order (torch unfold's
    order, zeros outside). Returns [B, 8H, 8W, 2]."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, 8, 8), dim=3)
    pad = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([pad[:, dy:dy + h, dx:dx + w, :]
                           for dy in range(3) for dx in range(3)], dim=3)  # [B, H, W, 9, 2]
    up = torch.einsum("bhwkpq,bhwkc->bhwpqc", mask, patches)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    """RAFT, small or basic, under the reference's parameter names
    (`fnet.*`, `cnet.*`, `update_block.*`). `generator` seeds the initial
    weights: the encoders' convolutions He fan-out normal (the reference's
    init), the update block's PyTorch's default uniform bounds."""

    corr_levels = 4

    def __init__(self, small: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.small = small
        self.corr_radius = 3 if small else 4
        self.hidden_dim = 96 if small else 128
        self.context_dim = 64 if small else 128
        corr_ch = self.corr_levels * (2 * self.corr_radius + 1) ** 2
        self.fnet = Encoder(128 if small else 256, "instance", small)
        self.cnet = Encoder(self.hidden_dim + self.context_dim,
                            "none" if small else "batch", small)
        block = SmallUpdateBlock if small else BasicUpdateBlock
        self.update_block = block(corr_ch, self.hidden_dim, self.context_dim)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator):
        for name, m in self.named_modules():
            if not isinstance(m, nn.Conv2d):
                continue
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            if name.startswith("update_block"):
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            else:
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                m.bias.zero_()

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12,
                flow_init: Optional[torch.Tensor] = None, all_iters: bool = False,
                plain: bool = False):
        """image1, image2 [B, H, W, 3] in [0, 255] (uint8 or float), H and W
        multiples of 8. Returns (flow_low [B, H/8, W/8, 2], flow_up
        [B, H, W, 2]), the reference's test-mode pair (`raft.py:159-160`);
        with `all_iters`, (flow_low, [iters, B, H, W, 2]): every
        iteration's full-resolution prediction. `plain=True` reads the
        correlation pyramid through the plain gather instead of K2's
        grid-sample entry (comparison runs on the card)."""
        hdim = self.hidden_dim
        scale = inv_f32(255)
        im1 = 2.0 * (image1.float() * scale) - 1.0
        im2 = 2.0 * (image2.float() * scale) - 1.0
        b = im1.shape[0]

        # one feature pass over both frames, as the reference's list input
        fmaps = self.fnet(torch.cat([im1, im2], dim=0).permute(0, 3, 1, 2))
        fmaps = fmaps.permute(0, 2, 3, 1)  # [2B, h, w, C]
        pyramid = build_corr_pyramid(fmaps[:b], fmaps[b:], self.corr_levels)

        c = self.cnet(im1.permute(0, 3, 1, 2))
        net = torch.tanh(c[:, :hdim])
        inp = F.relu(c[:, hdim:])

        _, h8, w8, _ = fmaps.shape
        coords0 = coords_grid(h8, w8, device=fmaps.device)[None].expand(b, h8, w8, 2)
        coords1 = coords0 if flow_init is None else coords0 + flow_init

        def up(flow_low, up_mask):
            if up_mask is None:
                return upflow8(flow_low)
            return convex_upsample_flow(flow_low, up_mask.permute(0, 2, 3, 1).float())

        up_mask = None
        preds = []
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = lookup_corr(pyramid, coords1, self.corr_radius, plain=plain)
            flow = coords1 - coords0
            net, up_mask, delta = self.update_block(
                net, inp, corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
            if all_iters:
                preds.append(up(coords1 - coords0, up_mask))

        flow_low = coords1 - coords0
        if all_iters:
            return flow_low, torch.stack(preds, dim=0)
        return flow_low, up(flow_low, up_mask)


def seeded_raft(small: bool, seed: int) -> RAFT:
    """A RAFT with random weights drawn from `seed`, for tests and smoke
    runs (no RAFT weights ship with the repository). The flow head's last
    convolution is scaled by 0.1: a random RAFT's forward and backward
    flows disagree, and at full scale (a few tenths of a coarse pixel) the
    cycle test masks every point of a small frame; scaled, part of it
    passes. Its flows carry no meaning."""
    model = RAFT(small, generator=torch.Generator().manual_seed(seed))
    head = model.update_block.flow_head.conv2
    with torch.no_grad():
        head.weight.mul_(0.1)
        head.bias.mul_(0.1)
    return model.eval()


@torch.no_grad()
def raft_batch_flows(model: RAFT, frames: torch.Tensor, iters: int = 12,
                     up: bool = False, micro_batch: Optional[int] = None,
                     plain: bool = False):
    """Frozen-RAFT flow stacks for live-flow pretraining (reference
    `util.calc_optical_flow`, `util.py:77-102`).

    frames [B, n, H, W, 3] uint8. Runs RAFT over the directed pair table,
    forward i -> i+1 for i < n-1, then backward i+1 -> i, one pair's forward
    at a time over micro-batches of `micro_batch` samples (snapped to the
    largest divisor of B), so that one pair's buffers are live at a time.
    Returns (flows_fwd, flows_bwd) [B, n-1, h, w, 2], h, w = H/8, W/8 (full
    resolution with `up`), the backward stack in reversed pair order
    (reference `util.py:88-91`)."""
    b, n = frames.shape[:2]
    if n < 2:
        raise ValueError("need at least two frames for flow")
    mb = b if micro_batch is None else min(micro_batch, b)
    if b % mb:
        mb = max(d for d in range(1, mb + 1) if b % d == 0)
    src = list(range(n - 1)) + list(range(1, n))
    dst = list(range(1, n)) + list(range(n - 1))
    flows = []
    for p_src, p_dst in zip(src, dst):
        chunks = [model(frames[c:c + mb, p_src], frames[c:c + mb, p_dst], iters=iters,
                        plain=plain)[1 if up else 0]
                  for c in range(0, b, mb)]
        flows.append(torch.cat(chunks))
    fwd = torch.stack(flows[:n - 1], dim=1)
    bwd = torch.stack(flows[n - 1:][::-1], dim=1)
    return fwd, bwd
