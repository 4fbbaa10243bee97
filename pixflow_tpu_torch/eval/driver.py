"""Linear-probe driver: the port of `pixflow_tpu/eval/driver.py`
(reference `main_linear.py:110-295`). A frozen pretrained backbone and an
fc probe, per-epoch training and validation, checkpoints every `save_freq`
epochs with the best acc1 so far, `--resume` / `--auto-resume` of the
probe itself.

One process, or one rank of a data-parallel job (`parallel/`: torchrun's
variables or a group the caller initialised): `total_batch_size` is the
global batch, each rank loads its rows of it and of the validation set,
the backbone's BatchNorm statistics and the fc gradients are averaged over
the ranks, and rank 0 alone writes checkpoints and `linear_val.jsonl`.

The validation metrics are sample-weighted means over the validation
loader's batches, summed over the ranks with `host_sum` (float64, to the
bit), so every rank returns the global numbers. Beside the log,
`linear_val.jsonl` in the output directory gets one line an epoch (and one
for `-e`): the validation loss, acc1, acc5, the best acc1 so far and the
epoch's median train-step time (from the end of one step to the end of the
next: loader wait included)."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..configs import LinearConfig
from ..data import ShardedLoader, VideoFrameDataset, get_transform, list_image_folder
from ..parallel import (Dist, broadcast_module_, check_mesh_shape, host_sum,
                        init_distributed, use_device, world_size)
from ..train.driver import to_device
from ..train.schedule import make_lr_schedule
from ..utils import latest_checkpoint, load_checkpoint, setup_logger
from ..utils.checkpoint import save_checkpoint_rank0
from .linear import (build_linear_state, encoder_state_dict, load_pretrained_encoder,
                     make_linear_eval_step, make_linear_train_step)


def check_ported(cfg: LinearConfig) -> None:
    """Raise ValueError for a `--mesh-shape` other than the world size."""
    check_mesh_shape(cfg.runtime.mesh_shape, world_size())


def _loader(cfg: LinearConfig, prefix: str, aug: str, batch: int,
            ctx: Dist) -> ShardedLoader:
    samples = list_image_folder(os.path.join(cfg.data.data_dir, prefix),
                                dataset=cfg.data.dataset)
    transform = get_transform(aug, cfg.data.crop, cfg.data.image_size, cfg.data.crop_ratio)
    ds = VideoFrameDataset(samples=samples, transform=transform, n_frames=1,
                           two_crop=False, video_mode=cfg.data.dataset == "bdd100k")
    return ShardedLoader(ds, batch, num_hosts=ctx.world_size, host_id=ctx.rank,
                         shuffle=prefix == "train",
                         num_threads=max(cfg.data.num_workers, 1), seed=cfg.runtime.seed)


def _batch(batch: dict) -> dict:
    return {"image": batch["im1"], "label": batch["target"].astype(np.int64)}


def evaluate(state, eval_step, loader: ShardedLoader, dev, group=None) -> dict:
    """Sample-weighted loss, acc1 and acc5 over the loader's batches, and
    over every rank's with `group` (each rank sums its own; `host_sum`
    adds the sums and the counts)."""
    sums = {"loss": 0.0, "acc1": 0.0, "acc5": 0.0}
    n = 0
    for batch in loader.epoch(0):
        batch = _batch(batch)
        m = eval_step(state, to_device(batch, dev))
        bs = batch["image"].shape[0]
        for k in sums:
            sums[k] += float(m[k]) * bs
        n += bs
    totals = host_sum({**sums, "n": float(n)}, group)
    n_total = max(totals.pop("n"), 1.0)
    return {k: v / n_total for k, v in totals.items()}


def linear_eval(cfg: LinearConfig, pretrained_path: str, pretrained_branch: str = "online",
                device=None) -> dict:
    """Train and validate the probe on one device (`cuda` unless told
    otherwise), or as one rank of a data-parallel job; returns the `-e`
    metrics or {"best_acc1": ...}, global on every rank."""
    check_ported(cfg)
    ctx, dev = init_distributed(device, mesh_shape=cfg.runtime.mesh_shape)
    use_device(dev)
    out_dir = cfg.runtime.output_dir
    os.makedirs(out_dir, exist_ok=True)
    logger = setup_logger(out_dir, ctx.rank, name="pixflow-linear")
    train_loader = _loader(cfg, "train", cfg.data.aug, cfg.total_batch_size, ctx)
    val_loader = _loader(cfg, "val", "val", cfg.total_batch_size, ctx)
    steps_per_epoch = len(train_loader)
    lr_schedule = make_lr_schedule(
        cfg.optim.lr_scheduler, cfg.optim.base_lr, cfg.optim.epochs, cfg.optim.warmup_epoch,
        steps_per_epoch, cfg.optim.warmup_multiplier, cfg.optim.lr_decay_epochs,
        cfg.optim.lr_decay_rate)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True  # fixed shapes: search once
    tx, state = build_linear_state(cfg.model.arch, cfg.num_classes, lr_schedule,
                                   cfg.optim.momentum, cfg.optim.weight_decay,
                                   seed=cfg.runtime.seed, device=dev, group=ctx.group)

    payload = torch.load(pretrained_path, map_location="cpu", weights_only=True)
    load_pretrained_encoder(state, encoder_state_dict(payload, pretrained_branch))
    logger.info("loaded pretrained %s encoder from %s (epoch %s)", pretrained_branch,
                pretrained_path, payload.get("epoch"))

    start_epoch, best_acc1 = cfg.optim.start_epoch, 0.0
    resume_path = cfg.runtime.resume
    if cfg.runtime.auto_resume and not resume_path:
        resume_path = latest_checkpoint(out_dir) or ""
    if resume_path:
        state, ckpt_epoch, extra = load_checkpoint(resume_path, state)
        start_epoch = ckpt_epoch + 1
        best_acc1 = float(extra.get("best_acc1", 0.0))
        logger.info("resumed linear probe from %s (epoch %d, best %.2f)", resume_path,
                    ckpt_epoch, best_acc1)
    broadcast_module_(state.model, ctx.group)  # the same on every rank already

    amp = torch.bfloat16 if cfg.runtime.compute_dtype == "bfloat16" else None
    train_step = make_linear_train_step(tx, lr_schedule, amp, group=ctx.group)
    eval_step = make_linear_eval_step(amp)

    def record(rec):
        logger.info("val %s", json.dumps(rec))
        if ctx.is_main:
            with open(os.path.join(out_dir, "linear_val.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")

    try:
        if cfg.eval_only:
            res = evaluate(state, eval_step, val_loader, dev, ctx.group)
            record({"epoch": start_epoch - 1, "eval_only": True, **res})
            return res
        for epoch in range(start_epoch, cfg.optim.epochs + 1):
            step_s = []
            t_end = time.perf_counter()
            for idx, batch in enumerate(train_loader.epoch(epoch)):
                state, m = train_step(state, to_device(_batch(batch), dev))
                if idx % cfg.runtime.print_freq == 0:
                    logger.info("Linear: [%d/%d][%d/%d] lr %.4f loss %.4f acc1 %.2f", epoch,
                                cfg.optim.epochs, idx, steps_per_epoch, float(m["lr"]),
                                float(m["loss"]), float(m["acc1"]))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                step_s.append(time.perf_counter() - t_end)
                t_end = time.perf_counter()
            res = evaluate(state, eval_step, val_loader, dev, ctx.group)
            best_acc1 = max(best_acc1, res["acc1"])
            record({"epoch": epoch, **res, "best_acc1": best_acc1, "steps": len(step_s),
                    "step_ms_median": 1e3 * float(np.median(step_s)) if step_s else None})
            if epoch % cfg.runtime.save_freq == 0:
                save_checkpoint_rank0(ctx, out_dir, epoch, state, cfg.to_json(),
                                      extra={"best_acc1": best_acc1})
        return {"best_acc1": best_acc1}
    finally:
        train_loader.close()
        val_loader.close()
