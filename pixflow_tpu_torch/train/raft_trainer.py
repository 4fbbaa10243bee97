"""RAFT training: the port of `pixflow_tpu/train/raft_trainer.py` (the
original RAFT recipe, which the reference ran out of tree): the
gamma-weighted sequence loss over every refinement iteration's
full-resolution prediction, AdamW with the linear one-cycle schedule, and
global-norm gradient clipping.

The optimizer is the port's own, in optax's op order, not
`torch.optim.AdamW` with `clip_grad_norm_`, which differ in three places:
- clipping scales only when the global norm is >= the limit, as
  (g / norm) * limit, with no epsilon (`clip_grad_norm_` adds 1e-6);
- weight decay is added to the Adam direction before the learning rate
  scales it, u = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)
  (`torch.optim.AdamW` first multiplies p by 1 - lr * wd);
- the learning rate is the schedule at the count before this step's
  increment.

On the card the correlation lookup's backward runs through K2's grid entry
backward kernel (`models/raft/corr.py`); RAFT's BatchNorm (basic's context
encoder) keeps its running statistics in training, as the JAX package's
`use_running_average=True`.

Data parallel (`group`): each rank steps on its rows of the global batch;
the sequence loss is a mean over equal local batches, so one all-reduce
after `backward()` averages the gradients (and sums the metrics' terms)
over the ranks before the clip, which then reads the global norm. The
frozen BatchNorm needs no statistics from the other ranks."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..models.raft import RAFT
from ..parallel.multihost import all_reduce_sum_

MAX_FLOW = 400.0  # pixels with |gt| >= MAX_FLOW are not supervised (RAFT)

_f32 = np.float32


def _sequence_loss_terms(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                         valid: torch.Tensor, gamma: float, max_flow: float):
    """(loss, counts): counts [5] = the final prediction's EPE summed over
    valid pixels, the valid pixels below 1, 3 and 5 px of EPE, and the
    valid pixels (the metrics' numerators and denominator, which add
    across ranks)."""
    n = flow_preds.shape[0]
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1))
    valid = (valid >= 0.5) & (mag < max_flow)
    vw = valid.float()[None, ..., None]
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=flow_preds.device)
    l1 = torch.abs(flow_preds - flow_gt[None])
    per_iter = torch.mean(l1 * vw, dim=(1, 2, 3, 4))
    loss = torch.sum(weights * per_iter)

    with torch.no_grad():
        epe = torch.sqrt(torch.sum((flow_preds[-1] - flow_gt) ** 2, dim=-1))
        epe_v = torch.where(valid, epe, torch.zeros((), device=epe.device))
        counts = torch.stack([epe_v.sum()] + [((epe_v < float(px)) & valid).sum().float()
                                              for px in (1, 3, 5)]
                             + [valid.sum().float()])
    return loss, counts


def _metrics(counts: torch.Tensor) -> dict:
    n_valid = torch.clamp(counts[4], min=1.0)
    return {"epe": counts[0] / n_valid, "1px": counts[1] / n_valid,
            "3px": counts[2] / n_valid, "5px": counts[3] / n_valid}


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor,
                  gamma: float = 0.8, max_flow: float = MAX_FLOW):
    """Gamma-weighted L1 over every iteration's prediction.

    flow_preds [N, B, H, W, 2], flow_gt [B, H, W, 2], valid [B, H, W]
    (>= 0.5: supervised). Iteration i weighs gamma^(N-1-i). The masked L1 is
    averaged over ALL elements, invalid ones included (the reference's
    `(valid[:, None] * i_loss).mean()`). Returns (loss, metrics) with the
    final prediction's EPE and 1px/3px/5px rates over valid pixels."""
    loss, counts = _sequence_loss_terms(flow_preds, flow_gt, valid, gamma, max_flow)
    return loss, _metrics(counts)


def one_cycle_schedule(lr_peak: float, total_steps: int,
                       pct_start: float = 0.05) -> Callable[[int], float]:
    """Linear warm-up from lr/25 to lr over max(int(total * pct_start), 1)
    steps, then linear decay to lr/1e4 (OneCycleLR, anneal 'linear'), in
    float32 as optax's `join_schedules` of two `linear_schedule`s."""
    warmup = max(int(total_steps * pct_start), 1)
    decay = max(total_steps - warmup, 1)

    def linear(init, end, steps, count):
        frac = _f32(1.0) - _f32(min(max(count, 0), steps)) / _f32(steps)
        return _f32(init - end) * frac + _f32(end)

    def schedule(count: int) -> float:
        if count < warmup:
            return float(linear(lr_peak / 25.0, lr_peak, warmup, count))
        return float(linear(lr_peak, lr_peak / 1e4, decay, count - warmup))

    return schedule


@dataclass
class AdamWState:
    count: int                          # updates taken (drives the schedule)
    mu: Dict[str, torch.Tensor]         # first moments
    nu: Dict[str, torch.Tensor]         # second moments


class ClippedAdamW:
    """optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, b1, b2,
    eps, weight_decay)) on a dict of parameters, updated in place with
    `torch._foreach_*` ops and no host synchronisation."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float,
                 clip_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(0, {n: torch.zeros_like(p) for n, p in params.items()},
                          {n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def clip(self, grads):
        """(g / norm) * clip_norm when the global norm is >= clip_norm, else
        g unchanged (bit for bit); returns (grads, norm)."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.clip_norm
        one = torch.ones((), device=norm.device)
        div = torch.where(keep, one, norm)
        mul = torch.where(keep, one, torch.full((), self.clip_norm, device=norm.device))
        return torch._foreach_mul(torch._foreach_div(grads, div), mul), norm

    @torch.no_grad()
    def step_(self, state: AdamWState, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Update params and state in place (a missing gradient counts as
        zero); returns the gradients' global norm before clipping."""
        names = list(state.mu)
        ps = [params[n] for n in names]
        gs = [grads[n] if grads.get(n) is not None else torch.zeros_like(params[n])
              for n in names]
        gs, norm = self.clip(gs)
        mus = [state.mu[n] for n in names]
        nus = [state.nu[n] for n in names]
        b1, b2 = self.b1, self.b2
        # optax: (1 - b) * g^k + b * moment
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1.0 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - b2))
        count = state.count + 1
        bc1 = float(_f32(1.0) - _f32(b1) ** _f32(count))
        bc2 = float(_f32(1.0) - _f32(b2) ** _f32(count))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nus, bc2)), self.eps)
        upd = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
        if self.weight_decay:
            upd = torch._foreach_add(upd, torch._foreach_mul(ps, self.weight_decay))
        torch._foreach_mul_(upd, -self.schedule(state.count))
        torch._foreach_add_(ps, upd)
        state.count = count
        return norm


def raft_optimizer(lr_peak: float, total_steps: int, weight_decay: float,
                   clip_norm: float = 1.0, pct_start: float = 0.05,
                   eps: float = 1e-8):
    """(schedule, optimizer): AdamW, the linear one-cycle schedule and
    global-norm clipping (the original RAFT `fetch_optimizer`)."""
    schedule = one_cycle_schedule(lr_peak, total_steps, pct_start)
    return schedule, ClippedAdamW(schedule, weight_decay, clip_norm, eps=eps)


@dataclass
class RaftTrainState:
    model: RAFT
    opt_state: AdamWState
    step: int = 0


def raft_train_state(model: RAFT, tx: ClippedAdamW) -> RaftTrainState:
    """The model with fresh Adam moments for each of its parameters (each
    once: a strided block's norm is registered under two names)."""
    return RaftTrainState(model, tx.init(dict(model.named_parameters())))


def make_raft_train_step(tx: ClippedAdamW, *, iters: int = 12, gamma: float = 0.8,
                         plain: bool = False, group=None):
    """A train step on RaftTrainState (updated in place): RAFT with every
    iteration's prediction, the sequence loss, its gradients, the clipped
    AdamW update. batch: img1/img2 [B, H, W, 3] float (0..255), flow
    [B, H, W, 2], valid [B, H, W], tensors on the model's device. Returns
    (state, metrics): loss, epe, 1px, 3px, 5px and grad_norm as 0-d
    tensors (reading them waits for the device). `plain=True` reads the
    correlation pyramid through the plain gather (comparison runs). With
    `group`, the gradients left in `.grad` and the metrics are the global
    batch's: the mean over the ranks, and the EPE rates over all ranks'
    valid pixels."""

    def step(state: RaftTrainState, batch: dict):
        model = state.model
        model.train()
        model.zero_grad(set_to_none=True)
        _, preds = model(batch["img1"], batch["img2"], iters=iters, all_iters=True,
                         plain=plain)
        loss, counts = _sequence_loss_terms(preds, batch["flow"], batch["valid"], gamma,
                                            MAX_FLOW)
        loss.backward()
        params = dict(model.named_parameters())
        loss = loss.detach()
        if group is not None:
            world = dist.get_world_size(group)
            grads = [p.grad for p in params.values() if p.grad is not None]
            scalars = torch.cat([loss.reshape(1), counts])
            all_reduce_sum_(grads + [scalars], group)
            torch._foreach_div_(grads, world)
            loss, counts = scalars[0] / world, scalars[1:]
        norm = tx.step_(state.opt_state, params, {n: p.grad for n, p in params.items()})
        state.step += 1
        return state, {"loss": loss, **_metrics(counts), "grad_norm": norm}

    return step
