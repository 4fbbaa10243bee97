"""LARS (layer-wise adaptive rate scaling) + momentum SGD: the port of
`pixflow_tpu/train/lars.py` (reference `contrast/lars.py`).

  * LARS rewrites the gradient ahead of SGD: add weight decay, then scale by
    trust_coef * ||p|| / (||g + wd*p|| + eps) when both norms are positive;
  * 1-D parameters (biases, BN scales) take the raw gradient: no decay, no
    trust scaling;
  * the frozen momentum branch (top-level modules whose name ends in `_k`)
    gets no update and keeps zero momentum, so weight decay never reaches
    the EMA-managed weights. Its buffers are not stored: they are zero.
  * the learning rate is the schedule at the optimizer's own count.

Parameters are updated in place, with `torch._foreach_*` ops (a few fused
launches per step on the card instead of several per tensor)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Union

import torch

Params = Dict[str, torch.Tensor]


def frozen_momentum_branch_names(names: Iterable[str]) -> set[str]:
    """Names under a top-level module ending in `_k` (the EMA branch)."""
    return {n for n in names if n.split(".", 1)[0].endswith("_k")}


@dataclass
class LarsSgdState:
    count: int                      # optimizer steps taken (drives the LR)
    momentum: Params                # SGD momentum of the trainable params


class LarsSgd:
    """Momentum SGD with optional LARS gradient rewrite (`lars_sgd`, `sgd`)."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 momentum: float, weight_decay: float, lars: bool,
                 trust_coef: float = 1e-3, eps: float = 1e-8,
                 frozen: Optional[set[str]] = None):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.lars = lars
        self.trust_coef = trust_coef
        self.eps = eps
        self.frozen = frozen or set()

    def init(self, params: Params) -> LarsSgdState:
        return LarsSgdState(0, {n: torch.zeros_like(p) for n, p in params.items()
                                if n not in self.frozen})

    @torch.no_grad()
    def step_(self, state: LarsSgdState, params: Params, grads: Params) -> None:
        """Update `params` and `state` in place from `grads` (missing or None
        gradients count as zero)."""
        lr = (self.learning_rate(state.count) if callable(self.learning_rate)
              else self.learning_rate)
        names = list(state.momentum)
        ps = [params[n] for n in names]
        gs = [grads.get(n) if grads.get(n) is not None else torch.zeros_like(params[n])
              for n in names]
        wd = self.weight_decay
        if self.lars:
            mat = [i for i, p in enumerate(ps) if p.ndim > 1]
            if mat:
                pm = [ps[i] for i in mat]
                gm = torch._foreach_add([gs[i] for i in mat], pm, alpha=wd)
                p_norm = torch.stack(torch._foreach_norm(pm))
                g_norm = torch.stack(torch._foreach_norm(gm))
                adaptive = torch.where((p_norm > 0.0) & (g_norm > 0.0),
                                       self.trust_coef * p_norm / (g_norm + self.eps),
                                       torch.ones_like(p_norm))
                torch._foreach_mul_(gm, list(adaptive.unbind()))
                for i, g in zip(mat, gm):
                    gs[i] = g
        else:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        bufs = [state.momentum[n] for n in names]
        torch._foreach_mul_(bufs, self.momentum)
        torch._foreach_add_(bufs, gs)
        torch._foreach_add_(ps, torch._foreach_mul(bufs, -lr))
        state.count += 1


def lars_sgd(learning_rate, momentum: float = 0.9, weight_decay: float = 1e-5,
             trust_coef: float = 1e-3, eps: float = 1e-8,
             frozen: Optional[set[str]] = None) -> LarsSgd:
    """LARS-wrapped momentum SGD (reference `--optimizer lars`)."""
    return LarsSgd(learning_rate, momentum, weight_decay, lars=True,
                   trust_coef=trust_coef, eps=eps, frozen=frozen)


def sgd(learning_rate, momentum: float = 0.9, weight_decay: float = 1e-4,
        frozen: Optional[set[str]] = None) -> LarsSgd:
    """Momentum SGD with coupled weight decay on every parameter (reference
    `--optimizer sgd`, torch.optim.SGD semantics)."""
    return LarsSgd(learning_rate, momentum, weight_decay, lars=False,
                   frozen=frozen)
