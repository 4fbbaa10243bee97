"""Cross-rank helpers: the port of `pixflow_tpu/parallel/multihost.py`.

Under GSPMD the JAX package's step is one program over the global batch;
here every rank runs the step on its own rows and these helpers make the
result the global one:

  * batches: `ShardedLoader(num_hosts=world, host_id=rank)` feeds rank r
    the rows [r*bs, (r+1)*bs) of every global batch (`local_rows` does the
    same to a batch in memory), so N ranks see what one process sees;
  * statistics and gradients: `all_reduce_mean` (autograd-aware, for
    BatchNorm's statistics) and `all_reduce_sum_` (one collective over a
    list of tensors: the gradients and the step's metrics);
  * state: every rank builds the same seeded model and reads the same
    checkpoint; `broadcast_module_` copies rank 0's tensors to be sure;
  * control flow: per-step decisions (SIGTERM preemption) are global
    (`any_process`), or ranks that keep stepping wait forever on
    collectives the stopped ranks never join;
  * host metrics: `host_sum` adds float64 values across ranks to the bit.

Only `all_reduce` and `broadcast` are used: gloo has no `all_gather` for
CUDA tensors. With `group` None every helper is the one-process identity."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _world(group) -> int:
    return dist.get_world_size(group)


def _host_device(group) -> torch.device:
    """Where a small host value crosses: NCCL moves CUDA tensors only."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the cotangent over ranks: each
    rank's statistics feed every rank's loss, so each rank's share of the
    gradient comes from all of them. (An in-place `dist.all_reduce` in the
    forward leaves the backward rank-local: the forward is right and the
    gradients are not.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of `x` over the ranks of `group`, differentiable (the JAX
    package's `lax.pmean`)."""
    return _AllReduceSum.apply(x, group) / _world(group)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group) -> None:
    """In place: each tensor becomes its sum over the ranks, in one
    collective over a flat buffer (all tensors of one dtype)."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    torch._foreach_copy_(list(tensors), [c.view(t.shape) for c, t in
                                         zip(flat.split([t.numel() for t in tensors]),
                                             tensors)])


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, group, src: int = 0) -> None:
    """In place: rank `src`'s parameters and buffers on every rank, one
    collective a dtype."""
    if group is None:
        return
    by_dtype: dict = {}
    for t in module.state_dict().values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        torch._foreach_copy_(ts, [c.view(t.shape) for c, t in
                                  zip(flat.split([t.numel() for t in ts]), ts)])


def any_process(flag: bool, group=None) -> bool:
    """Global OR of a per-rank bool (the preemption vote): a MAX all-reduce
    of an int."""
    if group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_host_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def host_sum(values: dict, group=None) -> dict:
    """Sum a dict of per-rank float metrics over the ranks (the evaluation's
    cross-rank reduction; the reference all-reduces acc1/acc5/loss at
    `main_linear.py:248-250`). Each rank writes its float64 values into its
    own row of a [world, K] table of zeros, the table is summed over ranks
    (x + 0 is exact) and each rank adds the rows in rank order: the same
    float64 bits on every rank, never rounded through float32."""
    if group is None:
        return {k: float(v) for k, v in values.items()}
    keys = sorted(values)
    table = torch.zeros((_world(group), len(keys)), dtype=torch.float64,
                        device=_host_device(group))
    table[dist.get_rank(group)] = torch.tensor([float(values[k]) for k in keys],
                                               dtype=torch.float64)
    dist.all_reduce(table, group=group)
    summed = table.cpu().numpy().sum(axis=0)
    return dict(zip(keys, summed.tolist()))


def host_mean(values: dict, group=None) -> dict:
    """`host_sum` over the world size: the mean of per-rank means over
    equal local batches."""
    if group is None:
        return {k: float(v) for k, v in values.items()}
    return {k: v / _world(group) for k, v in host_sum(values, group).items()}


def local_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s rows [r*bs, (r+1)*bs) of a global batch (bs = B /
    world), as `ShardedLoader` feeds them."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world:
            raise ValueError(f"{k}: batch {n} does not divide over {world} ranks")
        bs = n // world
        out[k] = v[rank * bs:(rank + 1) * bs]
    return out
