"""ResNet / ResNeXt backbones: the port of `pixflow_tpu/models/resnet.py`
(the reference's `contrast/resnet.py` zoo: same architectures, width/group/
dilation knobs, He fan-out init, zero-gamma on each block's last BN).

Input images are [B, H, W, 3] and the `early_return` head returns the c5
map [B, H/32, W/32, C]. Inside, convolutions take NCHW tensors in
`channels_last` memory (the same bytes as NHWC) and every BatchNorm is a
`ViewBatchNorm` over the channel-last view. Module names are the
reference's torch names (`conv1`, `bn1`, `layer1.0.conv2`,
`layer2.0.downsample.0`), so `convert.flax_to_torch` and the JAX package's
`torch_pixpro_to_flax` map the weights."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .norm import ViewBatchNorm


def he_fan_out_(conv: nn.Conv2d, generator: Optional[torch.Generator]) -> None:
    """normal(0, sqrt(2 / (k*k*out_channels))), the reference's Conv2d init."""
    kh, kw = conv.kernel_size
    std = math.sqrt(2.0 / (kh * kw * conv.out_channels))
    with torch.no_grad():
        conv.weight.normal_(0.0, std, generator=generator)


def _conv(cin, cout, k, stride=1, dilation=1, groups=1, generator=None) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k - 1) // 2,
                     dilation=dilation, groups=groups, bias=False)
    he_fan_out_(conv, generator)
    return conv


def bn_nchw(bn: ViewBatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Apply a channel-last BatchNorm to an NCHW (channels_last) tensor."""
    return bn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvBN(nn.Module):
    """conv -> BN, named `conv`/`bn` (the deep stem's cells)."""

    def __init__(self, cin, cout, k, stride=1, view_groups=1, bn_momentum=0.9,
                 generator=None):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride, generator=generator)
        self.bn = ViewBatchNorm(cout, view_groups, bn_momentum)

    def forward(self, x):
        return F.relu(bn_nchw(self.bn, self.conv(x)))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1, avg_down=False,
                 view_groups=1, bn_momentum=0.9, generator=None, **_):
        super().__init__()
        bn = lambda c, zero=False: ViewBatchNorm(c, view_groups, bn_momentum,
                                                 zero_init=zero)
        # like the JAX package, basic blocks take no dilation
        self.conv1 = _conv(inplanes, planes, 3, stride, generator=generator)
        self.bn1 = bn(planes)
        self.conv2 = _conv(planes, planes, 3, 1, generator=generator)
        self.bn2 = bn(planes, zero=True)
        self.avg_down = avg_down and stride != 1
        self.stride = stride
        self.downsample = _shortcut(inplanes, planes, stride, self.avg_down,
                                    view_groups, bn_momentum, generator)

    def forward(self, x):
        y = F.relu(bn_nchw(self.bn1, self.conv1(x)))
        y = bn_nchw(self.bn2, self.conv2(y))
        return F.relu(_apply_shortcut(self, x) + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, avg_down=False,
                 view_groups=1, bn_momentum=0.9, generator=None, groups=1,
                 base_width=64):
        super().__init__()
        bn = lambda c, zero=False: ViewBatchNorm(c, view_groups, bn_momentum,
                                                 zero_init=zero)
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = _conv(inplanes, width, 1, generator=generator)
        self.bn1 = bn(width)
        self.conv2 = _conv(width, width, 3, stride, dilation, groups, generator)
        self.bn2 = bn(width)
        self.conv3 = _conv(width, out_ch, 1, generator=generator)
        self.bn3 = bn(out_ch, zero=True)
        self.avg_down = avg_down and stride != 1
        self.stride = stride
        self.downsample = _shortcut(inplanes, out_ch, stride, self.avg_down,
                                    view_groups, bn_momentum, generator)

    def forward(self, x):
        y = F.relu(bn_nchw(self.bn1, self.conv1(x)))
        y = F.relu(bn_nchw(self.bn2, self.conv2(y)))
        y = bn_nchw(self.bn3, self.conv3(y))
        return F.relu(_apply_shortcut(self, x) + y)


def _shortcut(inplanes, out_ch, stride, avg_down, view_groups, bn_momentum,
              generator):
    """Projection shortcut `downsample` = (conv 1x1, BN), or None. With
    avg_down the stride moves to an average pool ahead of it."""
    if stride == 1 and inplanes == out_ch:
        return None
    conv_stride = 1 if avg_down else stride
    return nn.Sequential(_conv(inplanes, out_ch, 1, conv_stride, generator=generator),
                         ViewBatchNorm(out_ch, view_groups, bn_momentum))


def _apply_shortcut(block, x):
    if block.downsample is None:
        return x
    if block.avg_down:
        x = F.avg_pool2d(x, block.stride, block.stride)
    conv, bn = block.downsample
    return bn_nchw(bn, conv(x))


class ResNet(nn.Module):
    """Configurable ResNet trunk with the JAX package's `early_return` head
    (the c5 map, what PixPro's encoders use); the other heads serve linear
    evaluation and are not ported yet."""

    def __init__(self, block: str = "bottleneck", layers: Sequence[int] = (3, 4, 6, 3),
                 width: int = 1, groups: int = 1, width_per_group: int = 64,
                 avg_down: bool = False, deep_stem: bool = False,
                 layer4_dilation: int = 1, bn_momentum: float = 0.9,
                 view_groups: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        common = dict(view_groups=view_groups, bn_momentum=bn_momentum,
                      generator=generator)
        base = 64 * width
        self.deep_stem = deep_stem
        if deep_stem:
            self.stem1 = ConvBN(3, 32, 3, 2, **common)
            self.stem2 = ConvBN(32, 32, 3, 1, **common)
            self.stem3 = _conv(32, base, 3, generator=generator)
        else:
            self.conv1 = nn.Conv2d(3, base, 7, stride=2, padding=3, bias=False)
            he_fan_out_(self.conv1, generator)
        self.bn1 = ViewBatchNorm(base, view_groups, bn_momentum)

        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        strides = (1, 2, 2, 2 if layer4_dilation == 1 else 1)
        dilations = (1, 1, 1, layer4_dilation)
        inplanes = base
        for s, n_blocks in enumerate(layers):
            planes = base * 2 ** s
            blocks = []
            for i in range(n_blocks):
                blocks.append(block_cls(
                    inplanes, planes, stride=strides[s] if i == 0 else 1,
                    dilation=dilations[s], avg_down=avg_down, groups=groups,
                    base_width=width_per_group, **common))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.feature_dim = inplanes

    def forward(self, im: torch.Tensor) -> torch.Tensor:
        """im [B, H, W, C] -> c5 [B, H/32, W/32, feature_dim]."""
        x = im.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if self.deep_stem:
            x = self.stem3(self.stem2(self.stem1(x)))
        else:
            x = self.conv1(x)
        x = F.relu(bn_nchw(self.bn1, x))
        x = F.max_pool2d(x, 3, 2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.permute(0, 2, 3, 1)


# factory registry (`pixflow_tpu/models/resnet.py:MODEL_REGISTRY`)
MODEL_REGISTRY = {
    "resnet18": dict(block="basic", layers=(2, 2, 2, 2)),
    "resnet18_d": dict(block="basic", layers=(2, 2, 2, 2), deep_stem=True, avg_down=True),
    "resnet34": dict(block="basic", layers=(3, 4, 6, 3)),
    "resnet34_d": dict(block="basic", layers=(3, 4, 6, 3), deep_stem=True, avg_down=True),
    "resnet50": dict(block="bottleneck", layers=(3, 4, 6, 3)),
    "resnet50_w2x": dict(block="bottleneck", layers=(3, 4, 6, 3), width=2),
    "resnet50_16s": dict(block="bottleneck", layers=(3, 4, 6, 3), layer4_dilation=2),
    "resnet50_d": dict(block="bottleneck", layers=(3, 4, 6, 3), deep_stem=True, avg_down=True),
    "resnet101": dict(block="bottleneck", layers=(3, 4, 23, 3)),
    "resnet101_d": dict(block="bottleneck", layers=(3, 4, 23, 3), deep_stem=True, avg_down=True),
    "resnext101_32x8d": dict(block="bottleneck", layers=(3, 4, 23, 3), groups=32, width_per_group=8),
    "resnet152": dict(block="bottleneck", layers=(3, 8, 36, 3)),
    "resnet152_d": dict(block="bottleneck", layers=(3, 8, 36, 3), deep_stem=True, avg_down=True),
    "resnext152_32x8d": dict(block="bottleneck", layers=(3, 8, 36, 3), groups=32, width_per_group=8),
}


def make_resnet(arch: str, **overrides) -> ResNet:
    if arch not in MODEL_REGISTRY:
        raise ValueError(f"unknown arch '{arch}'; choose from {sorted(MODEL_REGISTRY)}")
    cfg = dict(MODEL_REGISTRY[arch])
    cfg.update(overrides)
    return ResNet(**cfg)
