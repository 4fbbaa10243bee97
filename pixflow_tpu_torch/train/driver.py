"""Pretraining driver: config -> model -> optimizer -> step
loop on one device. The port of `pixflow_tpu/train/driver.py`'s
`build_model`, `build_optimizer` and inner step loop; the data loader,
checkpoints and the CLI are not ported yet, so batches here come from
the caller or from `synthetic_batch`.

Logged steps (every `runtime.print_freq`) run the variant of the step with
the strided mask-ratio telemetry and read the metrics back to the host;
the others run the telemetry-free variant and do not wait for the device."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..configs import PretrainConfig
from ..device import resolve_device
from ..models import PixPro
from .lars import LarsSgd, frozen_momentum_branch_names, lars_sgd, sgd
from .schedule import make_lr_schedule, scale_lr
from .state import TrainState, create_train_state
from .train_step import make_train_step


def build_model(cfg: PretrainConfig, device=None) -> PixPro:
    """PixPro at the config's widths, seeded from `runtime.seed`, on the
    device (`cuda` unless told otherwise), convolution weights in
    channels_last memory."""
    dev = resolve_device(device)
    if cfg.flow.use_flow_frames and cfg.data.n_frames > 2:
        raise NotImplementedError("multi-span training is not ported yet")
    dtype = torch.bfloat16 if cfg.runtime.compute_dtype == "bfloat16" else torch.float32
    gen = torch.Generator().manual_seed(cfg.runtime.seed)
    model = PixPro(
        arch=cfg.model.arch,
        pixpro_p=cfg.model.pixpro_p,
        pixpro_clamp_value=cfg.model.pixpro_clamp_value,
        pixpro_transform_layer=cfg.model.pixpro_transform_layer,
        pixpro_pos_ratio=cfg.model.pixpro_pos_ratio,
        pixpro_ins_loss_weight=cfg.model.pixpro_ins_loss_weight,
        proj_out_dim=cfg.model.feature_dim,
        dtype=dtype,
        fuse_views=cfg.model.fuse_views,
        generator=gen,
    )
    return model.to(dev, memory_format=torch.channels_last)


def build_optimizer(cfg: PretrainConfig, lr_schedule, params) -> LarsSgd:
    """LARS or SGD over `params` (names -> tensors), momentum branch frozen."""
    frozen = frozen_momentum_branch_names(params)
    if cfg.optim.optimizer == "lars":
        return lars_sgd(lr_schedule, momentum=cfg.optim.momentum,
                        weight_decay=cfg.optim.weight_decay, frozen=frozen)
    if cfg.optim.optimizer == "sgd":
        return sgd(lr_schedule, momentum=cfg.optim.momentum,
                   weight_decay=cfg.optim.weight_decay, frozen=frozen)
    raise NotImplementedError(cfg.optim.optimizer)


@dataclass
class Trainer:
    state: TrainState
    step_fn: Callable          # logged steps: with flow telemetry
    step_fn_fast: Callable     # other steps: telemetry-free
    print_freq: int
    history: list = field(default_factory=list)


def build_trainer(cfg: PretrainConfig, device=None, steps_per_epoch: int = 1,
                  model: Optional[PixPro] = None,
                  plain_kernels: bool = False) -> Trainer:
    """Model (or the one given, e.g. with carried-over weights), optimizer,
    state and both step variants. `steps_per_epoch` sets the LR and EMA
    schedules' length, as the loader's length does in the JAX driver."""
    if model is None:
        model = build_model(cfg, device)
        copy_online = True
    else:
        copy_online = False
    batch_size = cfg.data.batch_size  # one device: global batch = per replica
    lr_schedule = make_lr_schedule(
        cfg.optim.lr_scheduler, scale_lr(cfg.optim.base_lr, batch_size),
        cfg.optim.epochs, cfg.optim.warmup_epoch, steps_per_epoch,
        cfg.optim.warmup_multiplier, cfg.optim.lr_decay_epochs,
        cfg.optim.lr_decay_rate)
    tx = build_optimizer(cfg, lr_schedule, dict(model.named_parameters()))
    state = create_train_state(
        model, tx, ema_k0=steps_per_epoch * (cfg.optim.start_epoch - 1),
        copy_online_to_momentum=copy_online)
    kw = dict(lr_schedule=lr_schedule,
              ema_total_steps=max(steps_per_epoch * cfg.optim.epochs, 1),
              ema_base_momentum=cfg.model.pixpro_momentum,
              use_flow=cfg.flow.use_flow, flow_up=cfg.flow.flow_up,
              flow_cat_norm=cfg.flow.flow_cat_norm,
              alpha1=cfg.flow.alpha1, alpha2=cfg.flow.alpha2,
              plain_kernels=plain_kernels)
    return Trainer(state, make_train_step(tx, **kw),
                   make_train_step(tx, flow_telemetry=False, **kw),
                   max(cfg.runtime.print_freq, 1))


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def run_steps(cfg: PretrainConfig, batches: Sequence[dict], n_steps: int,
              device=None, trainer: Optional[Trainer] = None) -> Trainer:
    """Run `n_steps` train steps over `batches` (cycled; numpy or tensors),
    continuing `trainer` when given. Logged steps append their metrics, as
    floats, to `trainer.history`."""
    dev = resolve_device(device)
    if trainer is None:
        trainer = build_trainer(cfg, dev)
    dev_batches = [to_device(b, dev) for b in batches]
    for i in range(n_steps):
        step = trainer.state.step
        logged = step % trainer.print_freq == 0
        fn = trainer.step_fn if logged else trainer.step_fn_fast
        trainer.state, metrics = fn(trainer.state, dev_batches[i % len(dev_batches)])
        if logged:
            trainer.history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
    return trainer


def _crop_coords(rng, b: int, h_img: int, w_img: int, near=None) -> np.ndarray:
    """[B, 10] crop vectors on an (h_img, w_img) frame; `near` places each
    crop within a tenth of the frame of another view's crop."""
    w = (w_img * rng.uniform(0.16, 0.5, b)).astype(np.int64)
    h = (h_img * rng.uniform(0.2, 0.55, b)).astype(np.int64)
    if near is None:
        j = (rng.uniform(0, 1, b) * (w_img - w)).astype(np.int64)
        i = (rng.uniform(0, 1, b) * (h_img - h)).astype(np.int64)
    else:
        j = np.clip(near[:, 4] + rng.integers(-w_img // 10, w_img // 10 + 1, b), 0, w_img - w)
        i = np.clip(near[:, 5] + rng.integers(-h_img // 10, h_img // 10 + 1, b), 0, h_img - h)
    W, H = w_img - 1, h_img - 1
    return np.stack([j / W, i / H, (j + w - 1) / W, (i + h - 1) / H,
                     j, i, w, h, np.full(b, w_img), np.full(b, h_img)],
                    axis=1).astype(np.float32)


def synthetic_batch(cfg: PretrainConfig, seed: int,
                    orig_hw: tuple[int, int] = (720, 1280)) -> dict:
    """A batch at the config's shapes, made with numpy from `seed`: uint8
    crops, two nearby crop windows on an `orig_hw` frame (BDD100k's 720p by
    default) and, for flow configs, n_frames - 1 smooth structured 1/8-res
    flows per direction: a per-sample affine motion plus noise (at 720p, a
    few coarse pixels, as the JAX package's multi-chip dry run makes them;
    scaled with the frame width otherwise), with the backward flows close
    to the reversed negated forward ones, so that the cycle mask keeps most
    points."""
    rng = np.random.default_rng(seed)
    b, s = cfg.data.batch_size, cfg.data.image_size
    h_img, w_img = orig_hw
    coord1 = _crop_coords(rng, b, h_img, w_img)
    batch = {
        "im1": rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
        "im2": rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
        "coord1": coord1,
        "coord2": _crop_coords(rng, b, h_img, w_img, near=coord1),
    }
    if cfg.flow.use_flow:
        k, fh, fw = cfg.data.n_frames - 1, h_img // 8, w_img // 8
        amp = np.float32(fw / 160)
        ys = np.linspace(-1, 1, fh, dtype=np.float32)[None, :, None]
        xs = np.linspace(-1, 1, fw, dtype=np.float32)[None, None, :]
        t = rng.uniform(-3, 3, (b, 2, 1, 1)).astype(np.float32)
        gx = rng.uniform(-1.5, 1.5, (b, 2, 1, 1)).astype(np.float32)
        gy = rng.uniform(-1.5, 1.5, (b, 2, 1, 1)).astype(np.float32)
        base = amp * (t + gx * xs + gy * ys).transpose(0, 2, 3, 1)  # [b, fh, fw, 2]
        noise = amp * 0.2 * rng.standard_normal((b, k, fh, fw, 2)).astype(np.float32)
        fwd = np.repeat(base[:, None], k, axis=1) + noise
        bwd = (-fwd[:, ::-1]
               + amp * 0.2 * rng.standard_normal(fwd.shape).astype(np.float32))
        batch["flows_fwd"] = np.ascontiguousarray(fwd)
        batch["flows_bwd"] = np.ascontiguousarray(bwd)
    return batch
