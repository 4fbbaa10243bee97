"""Rank processes for the port's data-parallel CPU tests
(`tests/test_torch_parallel.py`, `tests/test_torch_ddp.py`).

`spawn(case, world, payload)` starts `world` processes that join one gloo
group through torchrun's variables (`parallel.init_distributed`), each
with one torch thread, on the CPU or on one card that they share (gloo:
NCCL refuses two ranks on one device), and runs `case(ctx, payload)` in
every rank; each
rank's return value comes back to the caller through a file. A rank that
raises, dies or outlasts the timeout fails the call, and the others are
killed. This module imports torch and the port only, so a rank starts
without JAX."""

from __future__ import annotations

import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def torchrun_vars(rank: int, world: int, port: int) -> dict:
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": str(rank),
            "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank)}


def _entry(rank, case, world, port, payload, out_dir, device):
    from pixflow_tpu_torch.parallel import init_distributed, shutdown, use_device

    torch.set_num_threads(1)
    os.environ.update(torchrun_vars(rank, world, port))
    ctx, dev = init_distributed(device, backend="gloo")
    use_device(dev)
    try:
        result = case(ctx, payload)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown(ctx)


def spawn(case, world: int, payload=None, timeout: float = 300.0,
          device: str = "cpu") -> list:
    """[rank 0's result, rank 1's, ...] of `case(ctx, payload)`."""
    with tempfile.TemporaryDirectory(prefix="torch_ddp_") as out_dir:
        procs = mp.start_processes(_entry, args=(case, world, free_port(), payload, out_dir,
                                                 device),
                                   nprocs=world, join=False, start_method="spawn")
        deadline = time.time() + timeout
        try:
            while not procs.join(timeout=max(deadline - time.time(), 0.1)):
                if time.time() > deadline:
                    raise TimeoutError(f"{case.__name__}: ranks still running after "
                                       f"{timeout} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


# --- cases: tests/test_torch_parallel.py ---------------------------------------------

def _in_place_bn():
    """ViewBatchNorm with the trap: an in-place all-reduce of the statistics,
    invisible to autograd (the forward is global, the backward is not)."""
    from pixflow_tpu_torch.models import ViewBatchNorm

    class InPlace(ViewBatchNorm):
        def mean_over_ranks(self, stats):
            dist.all_reduce(stats, group=self.group)
            return stats / dist.get_world_size(self.group)

    return InPlace


def view_batch_norm_case(ctx, payload):
    """This rank's rows through a 2-group ViewBatchNorm over the group,
    autograd-aware and with the in-place trap: output, the gradients of
    sum(y * ct) for the input, weight and bias, and the running statistics."""
    from pixflow_tpu_torch.models import ViewBatchNorm

    dev = payload.get("device", "cpu")
    out = {}
    for name, cls in (("autograd", ViewBatchNorm), ("in_place", _in_place_bn())):
        x = torch.tensor(payload["x"][ctx.rank], device=dev, requires_grad=True)
        bn = cls(x.shape[-1], view_groups=2, momentum=0.9, group=ctx.group).to(dev)
        bn.load_state_dict({k: torch.tensor(v) for k, v in payload["state"].items()})
        y = bn(x)
        ct = torch.tensor(payload["ct"][ctx.rank], device=dev)
        gx, gw, gb = torch.autograd.grad(torch.sum(y * ct), [x, bn.weight, bn.bias])
        out[name] = {k: v.detach().cpu().numpy() for k, v in (
            ("y", y), ("gx", gx), ("gw", gw), ("gb", gb), ("mean", bn.running_mean),
            ("var", bn.running_var))}
    return out


def multihost_case(ctx, payload):
    """any_process over per-rank flags, host_sum of per-rank float64
    values."""
    from pixflow_tpu_torch.parallel import any_process, host_mean, host_sum

    votes = [any_process(flags[ctx.rank], ctx.group) for flags in payload["flags"]]
    values = {k: v[ctx.rank] for k, v in payload["values"].items()}
    return {"votes": votes, "sum": host_sum(values, ctx.group),
            "mean": host_mean(values, ctx.group)}


# --- cases: tests/test_torch_ddp.py --------------------------------------------------

def recipe_step_case(ctx, payload):
    """One PixPro train step (`make_train_step`) on this rank's rows of the
    global batch, from the given initial weights: metrics, the model's
    state_dict and the optimizer's momentum."""
    from pixflow_tpu_torch.models import PixPro
    from pixflow_tpu_torch.parallel import local_rows
    from pixflow_tpu_torch.train import (create_train_state, frozen_momentum_branch_names,
                                         lars_sgd, make_train_step, warmup_cosine)

    model = PixPro(**payload["model_kw"], group=ctx.group)
    model.load_state_dict(payload["state_dict"])
    model = model.to(memory_format=torch.channels_last)
    lr = warmup_cosine(1.0, **payload["lr"])
    tx = lars_sgd(lr, weight_decay=1e-5,
                  frozen=frozen_momentum_branch_names(dict(model.named_parameters())))
    state = create_train_state(model, tx, copy_online_to_momentum=False)
    step = make_train_step(tx, lr_schedule=lr, group=ctx.group, **payload["step_kw"])
    batch = local_rows(payload["batch"], ctx.rank, ctx.world_size)
    state, metrics = step(state, {k: torch.tensor(v) for k, v in batch.items()})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state_dict": {k: v.clone() for k, v in state.model.state_dict().items()},
            "momentum": {k: v.clone() for k, v in state.opt_state.momentum.items()}}


def raft_step_case(ctx, payload):
    """One RAFT train step (`make_raft_train_step`) on this rank's rows:
    the metrics and every parameter's gradient as the step leaves it."""
    from pixflow_tpu_torch.models.raft import seeded_raft
    from pixflow_tpu_torch.parallel import local_rows
    from pixflow_tpu_torch.train.raft_trainer import (make_raft_train_step, raft_optimizer,
                                                      raft_train_state)

    model = seeded_raft(True, seed=payload["seed"])
    _, tx = raft_optimizer(4e-4, 100, 1e-4)
    state = raft_train_state(model, tx)
    step = make_raft_train_step(tx, iters=payload["iters"], group=ctx.group)
    batch = local_rows(payload["batch"], ctx.rank, ctx.world_size)
    _, metrics = step(state, {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in batch.items()})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}


CASES = {"view_batch_norm": view_batch_norm_case, "multihost": multihost_case,
         "recipe_step": recipe_step_case, "raft_step": raft_step_case}


def run_cases(ctx, payload):
    """Several cases in one group: {case name: its payload} -> {case name:
    its result}."""
    return {name: CASES[name](ctx, p) for name, p in payload.items()}
