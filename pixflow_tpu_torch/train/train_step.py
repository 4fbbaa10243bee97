"""The PixPro train step: the port of `pixflow_tpu/train/train_step.py`
(non-multi-span path, lazy full-res flow_up).

Order within a step, as in the JAX package and the reference:

    EMA of the momentum branch with the pre-step online weights ->
    flows -> LazyFlowUp (+ strided mask telemetry on logged steps) ->
    forward of both branches (bf16 autocast when the model says so) ->
    pixel-pair loss (K1 on the card; the lazy flow points of each direction
    come from one flow_up_points launch) ->
    backward (K1's backward kernel on the card) -> LARS/SGD -> metrics.

The step runs eagerly and updates the state's model and optimizer state in
place. `plain_kernels=True` routes every kernel call site (pair sums and
their backward, the lazy flow evaluation and its telemetry) to the kernels'
plain PyTorch versions; it exists for comparison runs on the card
(`chip_smoke.py`), since on the CPU the wrappers take the plain versions by
themselves."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.pixpro import ema_update, momentum_schedule
from ..ops.flow_points import LazyFlowUp, mask_ratio_estimate
from .lars import LarsSgd
from .state import TrainState

# flow telemetry reads the cycle mask on every 32nd fine pixel per axis
MASK_RATIO_STRIDE = 32
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def prep_images(x: torch.Tensor) -> torch.Tensor:
    """Device-side ImageNet normalization of uint8 [B, H, W, 3] crops
    (float inputs are taken as already normalized)."""
    if x.dtype != torch.uint8:
        return x
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x.to(torch.float32) / 255.0 - mean) / std


def make_train_step(
    tx: LarsSgd,
    *,
    lr_schedule: Callable[[int], float],
    ema_total_steps: int,
    ema_base_momentum: float,
    use_flow: bool = False,
    flow_up: bool = False,
    flow_cat_norm: bool = False,
    alpha1: Optional[float] = None,
    alpha2: Optional[float] = None,
    flow_telemetry: bool = True,
    plain_kernels: bool = False,
):
    """Build `step_fn(state, batch) -> (state, metrics)`.

    batch (tensors on the model's device):
        im1, im2               [B, H, W, 3] uint8 (or normalized float32)
        coord1, coord2         [B, 10]
        flows_fwd, flows_bwd   [B, K, h, w, 2] (use_flow)
    metrics: 0-dim tensors (reading them waits for the device) and floats."""
    if use_flow and not flow_up:
        raise NotImplementedError(
            "composition at the stored 1/8 resolution (ops/flow.py) is not "
            "ported yet; the port runs the lazy full-res flow_up path")
    masked = alpha1 is not None and alpha2 is not None

    def step_fn(state: TrainState, batch: dict):
        model = state.model
        model.train()
        # EMA with the pre-step online weights, before the key forward
        m = momentum_schedule(state.ema_k, ema_total_steps, ema_base_momentum)
        ema_update(model, m)

        flow_fwd = flow_bwd = None
        mask_metrics = None
        if use_flow:
            fwd = batch["flows_fwd"].to(torch.float32).transpose(0, 1).contiguous()
            bwd = batch["flows_bwd"].to(torch.float32).transpose(0, 1).contiguous()

            def lazy(f, r):
                return LazyFlowUp(flows=f, flows_rev=r if masked else None,
                                  alpha1=alpha1, alpha2=alpha2,
                                  is_norm=flow_cat_norm, plain=plain_kernels)

            flow_fwd, flow_bwd = lazy(fwd, bwd), lazy(bwd, fwd)
            if flow_telemetry and masked:
                # exact mask values on a strided fine grid; logged steps only
                with torch.no_grad():
                    mask_metrics = tuple(
                        torch.mean(mask_ratio_estimate(
                            a, b, alpha1, alpha2, flow_cat_norm,
                            stride=MASK_RATIO_STRIDE, plain=plain_kernels))
                        for a, b in ((fwd, bwd), (bwd, fwd)))

        loss, stats = model(prep_images(batch["im1"]), prep_images(batch["im2"]),
                            batch["coord1"], batch["coord2"], flow_fwd, flow_bwd,
                            plain=plain_kernels)

        params = dict(model.named_parameters())
        names = list(state.opt_state.momentum)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        lr_metric = lr_schedule(state.step)
        tx.step_(state.opt_state, params, dict(zip(names, grads)))

        pos_num_1 = torch.sum(stats["pos_num_1"])
        pos_num_2 = torch.sum(stats["pos_num_2"])
        pos_mean_1 = torch.mean(stats["pos_mean_1"])
        pos_mean_2 = torch.mean(stats["pos_mean_2"])
        metrics = {
            "loss": loss.detach(),
            "lr": lr_metric,
            "ema_momentum": m,
            "pos_num_1": pos_num_1,
            "pos_num_2": pos_num_2,
            "pos_mean_1": pos_mean_1,
            "pos_mean_2": pos_mean_2,
            "pos_num": pos_num_1 + pos_num_2,
            "pos_mean": (pos_mean_1 + pos_mean_2) / 2.0,
        }
        if mask_metrics is not None:
            metrics["mask_ratio_fwd"], metrics["mask_ratio_bwd"] = mask_metrics

        state.step += 1
        state.ema_k += 1
        return state, metrics

    return step_fn
