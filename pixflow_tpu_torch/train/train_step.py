"""The PixPro train step: the port of `pixflow_tpu/train/train_step.py`.

Order within a step, as in the JAX package and the reference:

    EMA of the momentum branch with the pre-step online weights ->
    flows, from the batch or from live RAFT on its frames (`raft_fn`, the
    correlation lookup through K2's grid-sample entry on the card) ->
    the lazy flow_up (`LazyFlowUp`, evaluated at the loss's points;
    + strided mask telemetry on logged steps) or the materialising
    composition and cycle masks (`ops/flow.py:compose_and_mask`, K2's
    grid-sample entry on the card) ->
    images: ImageNet normalization, after the photometric augmentation on
    the device with `device_aug` ->
    forward of both branches (bf16 autocast when the model says so) ->
    pixel-pair loss (K1 on the card), over the two views, or over every
    (span, start) window of the frame stack with `use_flow_frames` ->
    backward (K1's backward kernel on the card) -> [data parallel: the
    gradients and the metrics summed over the ranks in one all-reduce, the
    gradients and the mean metrics divided by the world size] -> LARS/SGD.

Data parallel (`group`): each rank steps on its rows of the global batch
with a model whose BatchNorms take the same group (global statistics).
The loss is a per-sample mean, so the mean over ranks of the ranks' losses
and of their gradients is the global batch's; LARS then takes identical
gradients on every rank and the weights stay equal. One flat all-reduce
after `autograd.grad`, not DDP: the step differentiates with
`torch.autograd.grad` (DDP's hooks fire on `.backward()` into `.grad`) and
calls the model through methods other than `forward` (`multi_span_loss`),
and the BatchNorm buffers are equal on every rank by construction.
`pos_num` is summed over the ranks; loss, `pos_mean` and mask ratios are
averaged.

The step runs eagerly and updates the state's model and optimizer state in
place. `plain_kernels=True` routes every kernel call site (pair sums and
their backward, the lazy flow evaluation and its telemetry, the
materialising composition's reads; live RAFT's lookup through the
`raft_fn` that `train/driver.py` builds with the same switch) to the kernels' plain
PyTorch versions;
it exists for comparison runs on the card (`chip_smoke.py`), since on the
CPU the wrappers take the plain versions by themselves."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..models.pixpro import ema_update, momentum_schedule
from ..ops.augment import apply_photometric
from ..ops.flow import compose_and_mask, mask_ratio, span_windows
from ..ops.flow_points import LazyFlowUp, mask_ratio_estimate
from ..parallel.multihost import all_reduce_sum_
from .lars import LarsSgd
from .state import TrainState

# flow telemetry reads the cycle mask on every 32nd fine pixel per axis
MASK_RATIO_STRIDE = 32
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x / 255.0 - mean) / std


def prep_images(x: torch.Tensor) -> torch.Tensor:
    """Device-side ImageNet normalization of uint8 [..., H, W, 3] crops
    (float inputs are taken as already normalized)."""
    if x.dtype != torch.uint8:
        return x
    return _normalize(x.to(torch.float32))


def prep_images_aug(x: torch.Tensor, aug_params: torch.Tensor) -> torch.Tensor:
    """The photometric augmentation on the device (`ops/augment.py`), then
    ImageNet normalization: x [B, H, W, 3] crops with params [B, P], or
    [B, F, H, W, 3] multi-span stacks with params [B, F, P]."""
    if x.dim() == 5:
        b, f = x.shape[:2]
        y = apply_photometric(x.reshape((b * f,) + x.shape[2:]),
                              aug_params.reshape(b * f, -1))
        y = y.reshape((b, f) + y.shape[1:])
    else:
        y = apply_photometric(x, aug_params)
    return _normalize(y)


def make_train_step(
    tx: LarsSgd,
    *,
    lr_schedule: Callable[[int], float],
    ema_total_steps: int,
    ema_base_momentum: float,
    use_flow: bool = False,
    flow_up: bool = False,
    flow_up_lazy: bool = True,
    flow_cat_norm: bool = False,
    use_flow_frames: bool = False,
    alpha1: Optional[float] = None,
    alpha2: Optional[float] = None,
    flow_telemetry: bool = True,
    device_aug: bool = False,
    plain_kernels: bool = False,
    raft_fn: Optional[Callable] = None,
    group=None,
):
    """Build `step_fn(state, batch) -> (state, metrics)`.

    batch (tensors on the model's device):
        im1, im2               [B, H, W, 3] uint8 (or normalized float32)
        coord1, coord2         [B, 10]
        flows_fwd, flows_bwd   [B, K, h, w, 2] (use_flow from files)
        frames                 [B, n, H, W, 3] uint8 (use_flow with `raft_fn`)
        aug1, aug2             [B, P] photometric parameters (device_aug)
      multi-span (use_flow_frames), in place of the two crops:
        ims1, ims2             [B, F, H, W, 3], F = K
        coords1, coords2       [B, F, 10]
        n_frames_eff           [B] real frame counts
        augs1, augs2           [B, F, P] (device_aug)
    With `raft_fn` (live RAFT, `train/driver.py:make_raft_fn`) the flows
    are `raft_fn(batch["frames"])`, computed on the device each step, in
    place of the batch's flow keys. The lazy flow_up path runs when
    `flow_up and flow_up_lazy`; otherwise the flows are composed and masked
    as whole fields. metrics: 0-dim
    tensors (reading them waits for the device) and floats."""
    if use_flow_frames and not use_flow:
        raise ValueError("use_flow_frames requires use_flow")
    masked = alpha1 is not None and alpha2 is not None
    lazy_path = flow_up and flow_up_lazy

    def images(batch, key, aug_key):
        if device_aug:
            return prep_images_aug(batch[key], batch[aug_key])
        return prep_images(batch[key])

    def step_fn(state: TrainState, batch: dict):
        model = state.model
        model.train()
        # EMA with the pre-step online weights, before the key forward
        m = momentum_schedule(state.ema_k, ema_total_steps, ema_base_momentum)
        ema_update(model, m)

        flow_fwd = flow_bwd = mask_fwd = mask_bwd = None
        mask_metrics = None
        if use_flow:
            if raft_fn is not None:
                flows_fwd, flows_bwd = raft_fn(batch["frames"])
            else:
                flows_fwd = batch["flows_fwd"].to(torch.float32)
                flows_bwd = batch["flows_bwd"].to(torch.float32)
            if lazy_path:
                fwd = flows_fwd.transpose(0, 1).contiguous()  # [K, B, h, w, 2]
                bwd = flows_bwd.transpose(0, 1).contiguous()
                kk = fwd.shape[0]

                def lazy(f, r):
                    return LazyFlowUp(flows=f, flows_rev=r if masked else None,
                                      alpha1=alpha1, alpha2=alpha2,
                                      is_norm=flow_cat_norm, plain=plain_kernels)

                if use_flow_frames:
                    flow_fwd, flow_bwd = [], []
                    for span, s in span_windows(kk):
                        fw = fwd[s:s + span]
                        bw = bwd[kk - s - span:kk - s]
                        flow_fwd.append(lazy(fw, bw))
                        flow_bwd.append(lazy(bw, fw))
                else:
                    flow_fwd, flow_bwd = lazy(fwd, bwd), lazy(bwd, fwd)
                if flow_telemetry and masked:
                    # the full-span window's exact mask on a strided fine
                    # grid; logged steps only
                    with torch.no_grad():
                        mask_metrics = tuple(
                            torch.mean(mask_ratio_estimate(
                                a, b, alpha1, alpha2, flow_cat_norm,
                                stride=MASK_RATIO_STRIDE, plain=plain_kernels))
                            for a, b in ((fwd, bwd), (bwd, fwd)))
            else:
                with torch.no_grad():
                    flow_fwd, flow_bwd, mask_fwd, mask_bwd = compose_and_mask(
                        flows_fwd, flows_bwd, flow_up=flow_up,
                        use_flow_frames=use_flow_frames, alpha_1=alpha1,
                        alpha_2=alpha2, is_norm=flow_cat_norm, plain=plain_kernels)

        if use_flow_frames:
            loss, stats = model.multi_span_loss(
                images(batch, "ims1", "augs1"), images(batch, "ims2", "augs2"),
                batch["coords1"], batch["coords2"], flow_fwd, flow_bwd,
                mask_fwd, mask_bwd, span_windows(flows_fwd.shape[1]),
                batch["n_frames_eff"], plain=plain_kernels)
        else:
            loss, stats = model(images(batch, "im1", "aug1"), images(batch, "im2", "aug2"),
                                batch["coord1"], batch["coord2"], flow_fwd, flow_bwd,
                                mask_fwd, mask_bwd, plain=plain_kernels)

        params = dict(model.named_parameters())
        names = list(state.opt_state.momentum)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)

        sums = {"pos_num_1": torch.sum(stats["pos_num_1"]),
                "pos_num_2": torch.sum(stats["pos_num_2"])}
        means = {"loss": loss.detach(),
                 "pos_mean_1": torch.mean(stats["pos_mean_1"]),
                 "pos_mean_2": torch.mean(stats["pos_mean_2"])}
        if mask_fwd is not None:
            means["mask_ratio_fwd"] = torch.mean(mask_ratio(mask_fwd))
            means["mask_ratio_bwd"] = torch.mean(mask_ratio(mask_bwd))
        elif mask_metrics is not None:
            means["mask_ratio_fwd"], means["mask_ratio_bwd"] = mask_metrics
        if group is not None:
            world = dist.get_world_size(group)
            scalars = torch.stack([v.float() for v in (*sums.values(), *means.values())])
            reduced = [g for g in grads if g is not None]
            all_reduce_sum_(reduced + [scalars], group)
            torch._foreach_div_(reduced, world)
            values = scalars.unbind()
            sums = dict(zip(sums, values[:len(sums)]))
            means = {k: v / world for k, v in zip(means, values[len(sums):])}
        lr_metric = lr_schedule(state.step)
        tx.step_(state.opt_state, params, dict(zip(names, grads)))

        pos_num_1, pos_num_2 = sums["pos_num_1"], sums["pos_num_2"]
        pos_mean_1, pos_mean_2 = means["pos_mean_1"], means["pos_mean_2"]
        metrics = {
            "loss": means["loss"],
            "lr": lr_metric,
            "ema_momentum": m,
            "pos_num_1": pos_num_1,
            "pos_num_2": pos_num_2,
            "pos_mean_1": pos_mean_1,
            "pos_mean_2": pos_mean_2,
            "pos_num": pos_num_1 + pos_num_2,
            "pos_mean": (pos_mean_1 + pos_mean_2) / 2.0,
        }
        for key in ("mask_ratio_fwd", "mask_ratio_bwd"):
            if key in means:
                metrics[key] = means[key]

        state.step += 1
        state.ema_k += 1
        return state, metrics

    return step_fn
