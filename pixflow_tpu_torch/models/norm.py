"""Per-view-group BatchNorm for fused multi-view passes: the port of
`pixflow_tpu/models/norm.py`, with the JAX package's semantics rather than
`nn.BatchNorm2d`'s.

Over a fused [G*B, ..., C] batch (channels last), group g = rows
[g*B, (g+1)*B) is normalized with its own statistics, computed in float32
with flax's fast variance max(E[x^2] - E[x]^2, 0). The running averages keep
that **biased** variance and follow flax's momentum convention,
new = old * m + batch * (1 - m) with m = 0.9, and update group by group,
view 0 first: exactly G sequential BatchNorm calls. (`F.batch_norm` would
store the unbiased variance and use torch's momentum convention.) With
G = 1 it is the stock single-view BatchNorm. Eval mode (`.eval()`) uses
the running averages."""

from __future__ import annotations

import torch
from torch import nn


class ViewBatchNorm(nn.Module):
    """BatchNorm over the last axis whose train-mode statistics are per view
    group. Parameters `weight`/`bias` and buffers `running_mean`/
    `running_var` carry the reference's torch names."""

    def __init__(self, num_features: int, view_groups: int = 1,
                 momentum: float = 0.9, eps: float = 1e-5,
                 zero_init: bool = False):
        super().__init__()
        self.view_groups = view_groups
        self.momentum = momentum
        self.eps = eps
        init = torch.zeros if zero_init else torch.ones
        self.weight = nn.Parameter(init(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., C] -> same shape, in x's dtype (bf16 under autocast)."""
        c = x.shape[-1]
        if not self.training:
            y = (x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            return (y * self.weight + self.bias).to(x.dtype)

        g = self.view_groups
        if x.shape[0] % g:
            raise ValueError(f"fused batch {x.shape[0]} not divisible by "
                             f"view_groups={g}")
        xg = x.reshape(g, -1, c).float()
        mu = torch.mean(xg, dim=1)                       # [G, C]
        mu2 = torch.mean(torch.square(xg), dim=1)        # [G, C]
        var = torch.clamp(mu2 - torch.square(mu), min=0.0)
        y = (xg - mu[:, None]) * torch.rsqrt(var[:, None] + self.eps)
        y = y.reshape(x.shape) * self.weight + self.bias

        with torch.no_grad():
            m = self.momentum
            new_mean, new_var = self.running_mean, self.running_var
            for i in range(g):  # sequential, view 0 first (reference order)
                new_mean = new_mean * m + mu[i] * (1.0 - m)
                new_var = new_var * m + var[i] * (1.0 - m)
            self.running_mean.copy_(new_mean)
            self.running_var.copy_(new_var)
        return y.to(x.dtype)
