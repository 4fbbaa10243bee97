"""RAFT's feature and context encoders: the port of
`pixflow_tpu/models/raft/extractor.py` (the reference's
`contrast/flow/extractor.py`). A 7x7/2 stem, three stages of two residual
blocks and a 1x1 output conv; `small` takes bottleneck blocks and the
32/64/96 plan, basic plain blocks and 64/96/128. Tensors are NCHW inside.

Module names are the reference's torch names, so a published checkpoint
loads as it is: a strided block's norm is both `normN` and `downsample.1`,
as the reference registers it twice (`fnet.layer2.0.downsample.0.weight`,
`cnet.layer2.0.norm3.running_mean` = `...downsample.1.running_mean`).

Norms, as the JAX package's `_norm`: `instance` per sample and channel
without affine, `batch` with its running statistics only (RAFT is a frozen
flow oracle here: no mode switch changes that), `group` with C // 8 groups,
`none`; every eps 1e-5."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalises with its running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over H x W, no affine."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, eps=1e-5)


def make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "instance":
        return InstanceNorm()
    if kind == "group":
        return nn.GroupNorm(max(channels // 8, 1), channels, eps=1e-5)
    if kind == "batch":
        return FrozenBatchNorm2d(channels, eps=1e-5)
    if kind == "none":
        return nn.Identity()
    raise ValueError(kind)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        q = planes // 4
        self.conv1 = nn.Conv2d(in_planes, q, 1)
        self.conv2 = nn.Conv2d(q, q, 3, padding=1, stride=stride)
        self.conv3 = nn.Conv2d(q, planes, 1)
        self.norm1 = make_norm(norm_fn, q)
        self.norm2 = make_norm(norm_fn, q)
        self.norm3 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm4 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Encoder(nn.Module):
    """The basic or small encoder: [B, 3, H, W] -> [B, output_dim, H/8, W/8]."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 small: bool = False):
        super().__init__()
        stem = 32 if small else 64
        plan = (32, 64, 96) if small else (64, 96, 128)
        block = BottleneckBlock if small else ResidualBlock
        self.conv1 = nn.Conv2d(3, stem, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm_fn, stem)
        in_planes = stem
        for i, planes in enumerate(plan):
            stride = 1 if i == 0 else 2
            setattr(self, f"layer{i + 1}", nn.Sequential(
                block(in_planes, planes, norm_fn, stride),
                block(planes, planes, norm_fn, 1)))
            in_planes = planes
        self.conv2 = nn.Conv2d(in_planes, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)
