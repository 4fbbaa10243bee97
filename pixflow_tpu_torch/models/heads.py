"""Projection / prediction heads: the port of `pixflow_tpu/models/heads.py`.

`MLP2d` is the reference's 1x1-conv MLP (linear -> BN -> ReLU -> linear over
the channel axis); on channel-last [B, h, w, C] maps a 1x1 convolution is a
`Linear` over the last axis."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .norm import ViewBatchNorm


def dense(cin: int, cout: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """`nn.Linear` with flax Dense's default init: LeCun normal truncated at
    two standard deviations (std corrected for the truncation), zero bias."""
    lin = nn.Linear(cin, cout)
    std = math.sqrt(1.0 / cin) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        lin.bias.zero_()
    return lin


class MLP2d(nn.Module):
    def __init__(self, in_dim: int, inner_dim: int = 4096, out_dim: int = 256,
                 view_groups: int = 1, bn_momentum: float = 0.9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear1 = dense(in_dim, inner_dim, generator)
        self.bn1 = ViewBatchNorm(inner_dim, view_groups, bn_momentum)
        self.linear2 = dense(inner_dim, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, h, w, in_dim] -> [B, h, w, out_dim]."""
        return self.linear2(F.relu(self.bn1(self.linear1(x))))
