"""RAFT's update blocks: the port of `pixflow_tpu/models/raft/update.py`
(the reference's `contrast/flow/update.py`). Motion encoders, the
convolutional GRU (small) and the separable one (basic: 1x5, then 5x1),
the flow head and, in the basic block, the convex-upsampling mask head
(`mask.0`, `mask.2`, scaled by 0.25). NCHW tensors; module names are the
reference's."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 96, input_dim: int = 146):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz = nn.Conv2d(c, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(c, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(c, hidden_dim, 3, padding=1)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        c = hidden_dim + input_dim
        for axis, kernel, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{axis}",
                        nn.Conv2d(c, hidden_dim, kernel, padding=pad))

    def _half(self, h, x, convz, convr, convq):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(convz(hx))
        r = torch.sigmoid(convr(hx))
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = self._half(h, x, self.convz1, self.convr1, self.convq1)  # horizontal
        return self._half(h, x, self.convz2, self.convr2, self.convq2)  # vertical


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv = nn.Conv2d(128, 80, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)  # 82 channels


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(256, 126, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)  # 128 channels


class SmallUpdateBlock(nn.Module):
    def __init__(self, corr_channels: int, hidden_dim: int = 96, context_dim: int = 64):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_channels)
        self.gru = ConvGRU(hidden_dim, 82 + context_dim)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net)


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_channels: int, hidden_dim: int = 128, context_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels)
        self.gru = SepConvGRU(hidden_dim, 128 + context_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta = self.flow_head(net)
        # x0.25 to balance gradients (reference `update.py:139-152`)
        return net, 0.25 * self.mask(net), delta
