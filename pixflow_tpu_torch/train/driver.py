"""Pretraining driver: config -> loader -> model -> optimizer -> epochs.
The port of `pixflow_tpu/train/driver.py`: `train` builds the loader from
the config, the PixPro model and LARS/SGD with the loader's steps per
epoch, then runs the epoch loop with auto-resume, step-exact preemption
saves, checkpoints and per-step metric logging. `build_trainer`/`run_steps`
drive the same step on batches the caller gives, such as `synthetic_batch`.

Data parallel (`parallel/`, one process a card, torchrun's variables or a
group the caller initialised): the global batch is `batch_size x world`
and rank r's loader feeds its rows of it; the learning rate and the EMA
ramp follow the global batch and its steps per epoch; BatchNorm statistics,
gradients and metrics are reduced over the ranks in the step. Rank 0 alone
writes `config.json`, the metrics and the checkpoints (then a barrier);
every rank logs to its own file and reads a resume. The SIGTERM flag is a
vote of all ranks every `preempt_vote_steps` batches, at the same indices,
and once at the end of an epoch.

Logged steps (every `runtime.print_freq`, and the last of an epoch) run the
variant of the step with the strided mask-ratio telemetry and read the
metrics back to the host (with `runtime.mask_ratio_exact`, also the
reference's full-field mask ratio of the logged batch); the others run the
telemetry-free variant and do not wait for the device. Batches cross to the
card from pinned host memory without waiting (`to_device`)."""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..configs import PretrainConfig
from ..data import build_pretrain_loader
from ..data.datasets import frame_stats
from ..data.transforms import get_transform, sample_photometric_params
from ..device import resolve_device
from ..models import PixPro
from ..models.norm import use_group
from ..ops.kernels import KERNELS
from ..parallel import (Dist, any_process, broadcast_module_, check_mesh_shape,
                        host_mean, init_distributed, use_device, world_size)
from ..utils import AverageMeter, latest_checkpoint, load_checkpoint, setup_logger
from ..utils.checkpoint import load_published, save_checkpoint_rank0
from ..utils.metrics_writer import MetricsWriter
from .lars import LarsSgd, frozen_momentum_branch_names, lars_sgd, sgd
from .schedule import make_lr_schedule, scale_lr
from .state import TrainState, create_train_state
from .train_step import make_train_step


def multi_span(cfg: PretrainConfig) -> bool:
    """Whether the config trains on every (span, start) window of its frame
    stack (`use_flow_frames` with flows and more than two frames)."""
    return cfg.flow.use_flow_frames and cfg.flow.use_flow and cfg.data.n_frames > 2


def build_model(cfg: PretrainConfig, device=None, group=None) -> PixPro:
    """PixPro at the config's widths, seeded from `runtime.seed`, on the
    device (`cuda` unless told otherwise), convolution weights in
    channels_last memory; its BatchNorms average their statistics over
    `group`'s ranks when one is given. Multi-span keeps the views unfused,
    as the JAX package's driver does (B*F images a call already fill the
    device); fusing there is supported and exact (`PixPro.multi_span_loss`)."""
    dev = resolve_device(device)
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
        fuse_views=cfg.model.fuse_views and not multi_span(cfg),
        generator=gen,
        group=group,
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


def live_flow_micro_batch(flow_bs: Optional[int]) -> Optional[int]:
    """RAFT's micro-batch for live flows (`--flow_bs`), as the JAX
    package's on one device: unset, 4; <= 0, the whole batch at once; the
    reference's default was 8 a GPU (`contrast/util.py:136`)."""
    if flow_bs is None:
        return 4
    if flow_bs <= 0:
        return None
    return flow_bs


def make_raft_fn(cfg: PretrainConfig, device=None, plain_kernels: bool = False):
    """Live RAFT for the train step (the JAX driver's `_make_raft_fn`):
    returns (raft_fn, lazy_up), raft_fn(frames [B, n, H, W, 3] uint8) ->
    (flows_fwd, flows_bwd) [B, n-1, h, w, 2].

    With --flow_up, RAFT-small's full-resolution output is exactly
    `upflow8(flow_low)` (no convex head), which is what the lazy flow_up
    path evaluates at the loss's points: the small model therefore gives
    its coarse stack and the step takes the lazy path (`lazy_up`). RAFT-basic's
    convex upsampling needs its own full-resolution output; the step then
    composes those fields as they are and must not upsample them again.
    float32 only: K2's grid entry reads float32, and a bfloat16 RAFT is
    ROADMAP item 9."""
    from ..models.raft import load_raft, raft_batch_flows

    model = load_raft(cfg.flow.flow_model, small=cfg.flow.small).to(resolve_device(device))
    micro = live_flow_micro_batch(cfg.flow.flow_bs)
    lazy_up = cfg.flow.flow_up and cfg.flow.flow_up_lazy and cfg.flow.small

    def raft_fn(frames):
        return raft_batch_flows(model, frames, iters=cfg.flow.raft_iters,
                                up=cfg.flow.flow_up and not lazy_up, micro_batch=micro,
                                plain=plain_kernels)
    return raft_fn, lazy_up


def build_trainer(cfg: PretrainConfig, device=None, steps_per_epoch: int = 1,
                  model: Optional[PixPro] = None,
                  plain_kernels: bool = False, ctx: Dist = Dist()) -> Trainer:
    """Model (or the one given, e.g. with carried-over weights), optimizer,
    state and both step variants. `steps_per_epoch` sets the LR and EMA
    schedules' length, as the loader's length does in the JAX driver. A
    flow config without flow files gets live RAFT (`make_raft_fn`). With a
    group in `ctx`, the steps reduce over its ranks (a model given must
    have been built with the same group) and the learning rate scales with
    the global batch, `batch_size x world`."""
    if model is None:
        model = build_model(cfg, device, ctx.group)
        copy_online = True
    else:
        if ctx.group is not None:
            use_group(model, ctx.group)
        copy_online = False
    global_batch = cfg.data.batch_size * ctx.world_size
    lr_schedule = make_lr_schedule(
        cfg.optim.lr_scheduler, scale_lr(cfg.optim.base_lr, global_batch),
        cfg.optim.epochs, cfg.optim.warmup_epoch, steps_per_epoch,
        cfg.optim.warmup_multiplier, cfg.optim.lr_decay_epochs,
        cfg.optim.lr_decay_rate)
    tx = build_optimizer(cfg, lr_schedule, dict(model.named_parameters()))
    state = create_train_state(
        model, tx, ema_k0=steps_per_epoch * (cfg.optim.start_epoch - 1),
        copy_online_to_momentum=copy_online)
    raft_fn, raft_lazy_up = None, False
    if cfg.flow.use_flow and not cfg.flow.use_flow_file:
        raft_fn, raft_lazy_up = make_raft_fn(cfg, device, plain_kernels)
    kw = dict(lr_schedule=lr_schedule,
              ema_total_steps=max(steps_per_epoch * cfg.optim.epochs, 1),
              ema_base_momentum=cfg.model.pixpro_momentum,
              use_flow=cfg.flow.use_flow,
              # live RAFT-basic gives full-resolution flows under --flow_up
              flow_up=cfg.flow.flow_up and (raft_fn is None or raft_lazy_up),
              flow_up_lazy=cfg.flow.flow_up_lazy,
              flow_cat_norm=cfg.flow.flow_cat_norm,
              use_flow_frames=multi_span(cfg),
              alpha1=cfg.flow.alpha1, alpha2=cfg.flow.alpha2,
              device_aug=cfg.data.device_aug, plain_kernels=plain_kernels,
              raft_fn=raft_fn, group=ctx.group)
    return Trainer(state, make_train_step(tx, **kw),
                   make_train_step(tx, flow_telemetry=False, **kw),
                   max(cfg.runtime.print_freq, 1))


def to_device(batch: dict, device) -> dict:
    """Tensors on `device`. For the card, host arrays go through pinned
    memory and the copies do not wait: the caching host allocator keeps a
    pinned block until its copy has run."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


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


def _photometric_params(rng, shape: tuple, view: int) -> np.ndarray:
    """[*shape, PARAM_DIM] BYOL photometric parameters of view 1 or 2, drawn
    by the loader's own sampler from streams seeded by `rng`."""
    t = get_transform("BYOL", 0.08, device_photometric=True)[view - 1]
    seeds = rng.integers(0, 2 ** 31, int(np.prod(shape)))
    params = [sample_photometric_params(t.photometric, random.Random(int(x)))
              for x in seeds]
    return np.stack(params).reshape(*shape, -1).astype(np.float32)


def synthetic_batch(cfg: PretrainConfig, seed: int,
                    orig_hw: tuple[int, int] = (720, 1280)) -> dict:
    """A batch at the config's shapes, made with numpy from `seed`: uint8
    crops, two nearby crop windows on an `orig_hw` frame (BDD100k's 720p by
    default) and, for flow configs, n_frames - 1 smooth structured 1/8-res
    flows per direction: a per-sample affine motion plus noise (at 720p, a
    few coarse pixels, as the JAX package's multi-chip dry run makes them;
    scaled with the frame width otherwise), with the backward flows close
    to the reversed negated forward ones, so that the cycle mask keeps most
    points.

    Multi-span configs (`multi_span`) get the loader's multi-span keys in
    place of the two crops: `ims1`/`ims2` [B, F, S, S, 3] uint8 and
    `coords1`/`coords2` [B, F, 10] (F = n_frames - 1; every crop within a
    tenth of the frame of one window per sample) and `n_frames_eff` [B]
    (every video whole). With `data.device_aug`, BYOL photometric parameters
    `aug1`/`aug2` [B, P], or `augs1`/`augs2` [B, F, P]. Live-RAFT configs
    (flows without flow files) get `frames` [B, n_frames, *orig_hw, 3]
    uint8 in place of the flows: a drifting colour grating a sample
    (`data/synthetic.py`), moved by a whole number of pixels a frame."""
    rng = np.random.default_rng(seed)
    b, s = cfg.data.batch_size, cfg.data.image_size
    h_img, w_img = orig_hw
    if multi_span(cfg):
        f = cfg.data.n_frames - 1
        anchor = _crop_coords(rng, b, h_img, w_img)
        crops = lambda: np.stack([_crop_coords(rng, b, h_img, w_img, near=anchor)
                                  for _ in range(f)], axis=1)
        batch = {
            "ims1": rng.integers(0, 256, (b, f, s, s, 3), dtype=np.uint8),
            "ims2": rng.integers(0, 256, (b, f, s, s, 3), dtype=np.uint8),
            "coords1": crops(),
            "coords2": crops(),
            "n_frames_eff": np.full(b, cfg.data.n_frames, np.int32),
        }
        if cfg.data.device_aug:
            batch["augs1"] = _photometric_params(rng, (b, f), 1)
            batch["augs2"] = _photometric_params(rng, (b, f), 2)
    else:
        coord1 = _crop_coords(rng, b, h_img, w_img)
        batch = {
            "im1": rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
            "im2": rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
            "coord1": coord1,
            "coord2": _crop_coords(rng, b, h_img, w_img, near=coord1),
        }
        if cfg.data.device_aug:
            batch["aug1"] = _photometric_params(rng, (b,), 1)
            batch["aug2"] = _photometric_params(rng, (b,), 2)
    if cfg.flow.use_flow and not cfg.flow.use_flow_file:
        from ..data.synthetic import grating_frame
        n = cfg.data.n_frames
        frames = np.empty((b, n, h_img, w_img, 3), np.uint8)
        shifts = rng.integers(-3, 4, (b, 2))
        for i in range(b):
            base = grating_frame(seed * 100003 + i, 0, (h_img, w_img))
            for f in range(n):
                frames[i, f] = np.roll(base, tuple(f * shifts[i]), axis=(0, 1))
        batch["frames"] = frames
    elif cfg.flow.use_flow:
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


# --- the training entry point -------------------------------------------------

def check_ported(cfg: PretrainConfig) -> None:
    """Raise NotImplementedError, naming its ROADMAP.md item, for every
    setting whose path the port does not have yet: no other path runs in
    its place. A `--mesh-shape` other than the world size raises
    ValueError (`parallel.check_mesh_shape`)."""
    d, f, r = cfg.data, cfg.flow, cfg.runtime
    missing = [
        (f.use_flow and not f.use_flow_file and f.raft_dtype != "float32",
         f"--raft_dtype {f.raft_dtype}, a bfloat16 live RAFT (item 9)"),
        (f.use_flow and not f.use_flow_file and f.raft_corr_dtype == "bfloat16",
         "--raft_corr_dtype bfloat16, a bfloat16 correlation pyramid (item 9)"),
        (r.checkpoint_backend == "orbax",
         "--checkpoint-backend orbax, a JAX library (rank 0's torch.save checkpoint is "
         "its counterpart; item 4)"),
        (d.loader_backend == "grain",
         "--loader-backend grain, absent on the card's machine (item 4)"),
        (r.wandb, "--wandb (item 1, left out of the port's CLI)"),
        (r.debug, "--debug, utils/visualize.py (item 7)"),
    ]
    for unported, what in missing:
        if unported:
            raise NotImplementedError(f"{what} is not ported (ROADMAP.md, Queue 1)")
    check_mesh_shape(r.mesh_shape, world_size())


def _exact_mask_ratio_fn(cfg: PretrainConfig) -> Callable:
    """`--mask-ratio-exact`: the reference's full-field mask ratio
    (`util.py:360-366`) of a logged batch, through the materialising
    composition (K2's grid-sample entry on the card), in place of the
    per-step strided estimate. (flows_fwd, flows_bwd) [B, K, h, w, 2] ->
    (fwd, bwd) floats, averaged over the batch and, multi-span, the
    windows."""
    from ..ops.flow import compose_and_mask, mask_ratio

    @torch.no_grad()
    def ratio(flows_fwd, flows_bwd):
        _, _, mf, mb = compose_and_mask(
            flows_fwd.to(torch.float32), flows_bwd.to(torch.float32),
            flow_up=cfg.flow.flow_up, use_flow_frames=multi_span(cfg),
            alpha_1=cfg.flow.alpha1, alpha_2=cfg.flow.alpha2,
            is_norm=cfg.flow.flow_cat_norm)
        return float(torch.mean(mask_ratio(mf))), float(torch.mean(mask_ratio(mb)))

    return ratio


def _verbose_dump(batch, n_frames: int, rank: int = 0):
    """--verbose: raw numeric dumps from the flow path, the reference's
    debug-print-for-raft flag (`contrast/option.py:79`). Each array prints
    dtype/shape/min/max/mean plus its first 8 raw values (the JAX driver's
    bounded form of the reference's whole-tensor prints)."""
    for key in ("frames", "flows_fwd", "flows_bwd", "im1", "im2",
                "ims1", "ims2"):
        if key not in batch:
            continue
        a = np.asarray(batch[key])
        head = np.array2string(a.reshape(-1)[:8], precision=4, separator=", ")
        print(f"rank: {rank} {key}: {a.dtype} {tuple(a.shape)} "
              f"min {float(a.min()):.5g} max {float(a.max()):.5g} "
              f"mean {float(a.mean(dtype=np.float64)):.5g} head {head}",
              flush=True)
    for key in ("coord1", "coord2", "coords1", "coords2"):
        if key in batch:
            a = np.asarray(batch[key])
            print(f"rank: {rank} {key}: {a.dtype} {tuple(a.shape)}",
                  np.round(a.reshape(a.shape[0], -1), 4).tolist(), flush=True)
    print(f"rank: {rank} n_frames: {n_frames}", flush=True)


def _peak_memory_mb(dev: torch.device) -> Optional[float]:
    """Peak bytes allocated on the card (the reference's
    max_memory_allocated log field); None on the CPU."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e6


def _warm_start(model: PixPro, path: str, logger) -> None:
    """Published weights (reference load_pretrained, `main_pretrain.py:86-93`):
    the model's parameters and BatchNorm buffers that the file names; the
    optimizer starts fresh."""
    pub = load_published(path)
    own = model.state_dict()
    found = {k: v for k, v in pub["model"].items() if k in own}
    model.load_state_dict(found, strict=False)
    logger.info("loaded pretrained model %s (epoch %s, %d tensors)",
                path, pub.get("epoch"), len(found))


def train(cfg: PretrainConfig, device=None, model: Optional[PixPro] = None) -> TrainState:
    """Pretrain from the files the config names; returns the final
    TrainState. One process on one device (`cuda` unless told otherwise),
    or rank r of a data-parallel job: the group a caller initialised, or
    one made from torchrun's variables (`parallel.init_distributed`; the
    card is then `cuda:LOCAL_RANK`). `model` takes an already built PixPro,
    e.g. with weights carried over from the JAX package, in place of a
    seeded one."""
    check_ported(cfg)
    ctx, dev = init_distributed(device, mesh_shape=cfg.runtime.mesh_shape)
    # preemption-safe checkpointing: on SIGTERM, finish the in-flight step,
    # save, and return so that --auto-resume continues step-exactly.
    stop_requested = threading.Event()
    prev_handler = None
    try:
        prev_handler = signal.signal(signal.SIGTERM, lambda *_: stop_requested.set())
    except ValueError:
        pass  # not the main thread
    try:
        return _train(cfg, dev, model, stop_requested, ctx)
    finally:
        if prev_handler is not None:
            try:
                signal.signal(signal.SIGTERM, prev_handler)
            except ValueError:
                pass


def _train(cfg: PretrainConfig, dev: torch.device, model: Optional[PixPro],
           stop_requested: threading.Event, ctx: Dist) -> TrainState:
    out_dir = cfg.runtime.output_dir
    logger = setup_logger(out_dir, ctx.rank)
    if ctx.is_main:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
        logger.info("config:\n%s", cfg.to_json())
    global_batch = cfg.data.batch_size * ctx.world_size
    logger.info("device: %s, rank %d of %d (%s), global batch %d", dev, ctx.rank,
                ctx.world_size, ctx.backend, global_batch)

    loader = build_pretrain_loader(cfg, global_batch_size=global_batch,
                                   num_hosts=ctx.world_size, host_id=ctx.rank)
    metrics_writer = profiler = None
    try:
        restart_transcode = cfg.data.restart_transcode and cfg.data.native_decode
        if cfg.data.restart_transcode and not restart_transcode:
            logger.warning("--restart-transcode requires --native-decode; "
                           "ignoring it (no in-memory transcode, no byte cache)")
        if cfg.data.cache_mode != "no" and (cfg.data.zip_mode or restart_transcode):
            loader.dataset.init_cache(cfg.data.cache_mode, ctx.rank, ctx.world_size)
        # forked decode workers start before this process first touches CUDA
        loader.start_workers()
        use_device(dev)
        steps_per_epoch = len(loader)
        logger.info("dataset: %d instances, %d steps/epoch",
                    len(loader.dataset), steps_per_epoch)

        if dev.type == "cuda":
            torch.backends.cudnn.benchmark = True  # fixed shapes: search once
        if model is not None:
            model = model.to(dev, memory_format=torch.channels_last)
        trainer = build_trainer(cfg, dev, steps_per_epoch, model=model, ctx=ctx)
        state = trainer.state
        if cfg.runtime.pretrained_model:
            _warm_start(state.model, cfg.runtime.pretrained_model, logger)

        start_epoch = cfg.optim.start_epoch
        resume_skip, resume_skip_epoch = 0, -1
        resume_path = cfg.runtime.resume
        if cfg.runtime.auto_resume and not resume_path:
            resume_path = latest_checkpoint(out_dir) or ""
        ckpt_extra = {}
        if resume_path:  # every rank reads it
            state, ckpt_epoch, ckpt_extra = load_checkpoint(resume_path, state)
            start_epoch = ckpt_epoch + 1
            logger.info("resumed from %s (epoch %d, step %d)",
                        resume_path, ckpt_epoch, state.step)
        if ckpt_extra.get("resume_idx"):
            # step-exact preemption resume: re-enter the interrupted epoch and
            # fast-forward its deterministic stream past the completed batches
            start_epoch = int(ckpt_extra["resume_epoch"])
            resume_skip = int(ckpt_extra["resume_idx"])
            resume_skip_epoch = start_epoch
            logger.info("step-exact resume: epoch %d from batch %d",
                        start_epoch, resume_skip)
        # the same seed and files give every rank the same state; rank 0's
        # copy makes sure of it
        broadcast_module_(state.model, ctx.group)

        def save(epoch_, extra_=None):
            return save_checkpoint_rank0(ctx, out_dir, epoch_, state, cfg.to_json(), extra_)

        max_epoch = cfg.optim.epochs
        if cfg.runtime.debug_epochs:
            max_epoch = min(max_epoch, start_epoch + cfg.runtime.debug_epochs - 1)
        exact_mask = None
        if (cfg.runtime.mask_ratio_exact and cfg.flow.use_flow
                and cfg.flow.alpha1 is not None and cfg.flow.alpha2 is not None):
            exact_mask = _exact_mask_ratio_fn(cfg)
        if ctx.is_main:
            metrics_writer = MetricsWriter(out_dir, use_tensorboard=cfg.runtime.tensorboard)
        launches0 = {k.__name__: k.launches for k in KERNELS}
        loss_meter, time_meter = AverageMeter(), AverageMeter()
        global_step = state.step
        # one process reads its flag every step; ranks vote every
        # preempt_vote_steps batches, all at the same indices (a rank that
        # stopped on its own flag would leave the others in the next step's
        # collectives), and once at the end of an epoch
        vote_every = max(1, int(cfg.runtime.preempt_vote_steps))

        def poll_preempt(idx):
            if ctx.group is None:
                return stop_requested.is_set()
            if idx % vote_every:
                return False
            return any_process(stop_requested.is_set(), ctx.group)

        for epoch in range(start_epoch, max_epoch + 1):
            t_end = time.time()
            skip = resume_skip if epoch == resume_skip_epoch else 0
            preempt_idx = None
            preempted = False
            for idx, batch in enumerate(loader.epoch(epoch, skip_batches=skip), start=skip):
                if poll_preempt(idx):
                    preempted = True
                    preempt_idx = idx  # this batch has NOT been stepped
                    break
                if multi_span(cfg):  # the step weights its windows by it
                    n_eff = batch.get("n_frames_eff")
                else:
                    n_eff = batch.pop("n_frames_eff", None)
                batch.pop("index", None)
                batch.pop("target", None)
                if cfg.runtime.verbose and cfg.flow.use_flow:
                    _verbose_dump(batch, cfg.data.n_frames, ctx.rank)
                device_batch = to_device(batch, dev)

                # optional profiler window over steps 10..15
                if cfg.runtime.profile_dir and global_step == 10 and profiler is None:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if dev.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                logged_step = (idx % cfg.runtime.print_freq == 0
                               or idx == steps_per_epoch - 1)
                fn = trainer.step_fn if logged_step else trainer.step_fn_fast
                state, metrics = fn(state, device_batch)
                global_step += 1
                if profiler is not None and global_step >= 15:
                    profiler.stop()
                    os.makedirs(cfg.runtime.profile_dir, exist_ok=True)
                    trace = os.path.join(cfg.runtime.profile_dir,
                                         "trace.json" if ctx.is_main
                                         else f"trace.rank{ctx.rank}.json")
                    profiler.export_chrome_trace(trace)
                    profiler = None
                    logger.info("profiler trace written to %s", trace)

                if logged_step:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    loss_meter.update(metrics["loss"], global_batch)
                    time_meter.update(time.time() - t_end)
                    extra = ""
                    if "mask_ratio_fwd" in metrics:
                        extra = (f" mask_r {metrics['mask_ratio_fwd']:.3f}/"
                                 f"{metrics['mask_ratio_bwd']:.3f}")
                    if exact_mask is not None and "flows_fwd" in device_batch:
                        r_f, r_b = exact_mask(device_batch["flows_fwd"],
                                              device_batch["flows_bwd"])
                        r = host_mean({"fwd": r_f, "bwd": r_b}, ctx.group)
                        metrics["mask_ratio_exact_fwd"] = r_f = r["fwd"]
                        metrics["mask_ratio_exact_bwd"] = r_b = r["bwd"]
                        extra += f" mask_r_exact {r_f:.3f}/{r_b:.3f}"
                    if n_eff is not None:
                        mean_f, no_flow_r, _ = frame_stats(n_eff, cfg.data.n_frames)
                        f_stats = host_mean({"mean": mean_f, "no_flow": no_flow_r},
                                            ctx.group)
                        mean_f, no_flow_r = f_stats["mean"], f_stats["no_flow"]
                        extra += f" frames {mean_f:.2f} (no-flow {no_flow_r:.1%})"
                    mem_mb = _peak_memory_mb(dev)
                    if mem_mb is not None:
                        extra += f" mem {mem_mb:.0f}MB"
                    logger.info(
                        "Train: [%d/%d][%d/%d] time %.3f lr %.4f "
                        "loss %.4f (%.4f) [+4: %.4f] pos_num %.4g pos_mean %.3f%s",
                        epoch, cfg.optim.epochs, idx, steps_per_epoch,
                        time_meter.val, metrics["lr"], metrics["loss"],
                        loss_meter.avg, metrics["loss"] + 4.0,
                        metrics["pos_num"], metrics["pos_mean"], extra)
                    if metrics_writer is not None:
                        scalars = dict(metrics)
                        scalars["loss_plus4"] = metrics["loss"] + 4.0
                        scalars["epoch"] = epoch
                        # seconds since the previous step ended, loader wait
                        # and the unlogged steps' device work included (the
                        # log line's `time`)
                        scalars["time"] = time_meter.val
                        if mem_mb is not None:
                            scalars["peak_memory_mb"] = mem_mb
                        if n_eff is not None:
                            scalars["mean_n_frames"] = mean_f
                            scalars["no_optical_flow_ratio"] = no_flow_r
                        metrics_writer.write(global_step, scalars)
                t_end = time.time()

            if not preempted:
                # TERM after the epoch's last batch: still a vote, so every
                # rank takes the same branch below
                preempted = any_process(stop_requested.is_set(), ctx.group)
            if preempted:
                # step-exact preemption: record (epoch, next batch) so resume
                # fast-forwards the deterministic loader stream — no redone
                # steps, no skipped data, step counter exact
                extra = ({"resume_epoch": epoch, "resume_idx": preempt_idx}
                         if preempt_idx is not None else None)
                # TERM after the epoch's last batch: the epoch IS complete
                done = epoch if preempt_idx is None else epoch - 1
                path = save(max(done, start_epoch - 1), extra)
                logger.info("SIGTERM: %s at step %d (resume %s); exiting cleanly",
                            f"saved preemption checkpoint {path}" if path else
                            "rank 0 saved the preemption checkpoint", state.step,
                            f"epoch {epoch} batch {preempt_idx}"
                            if preempt_idx is not None else f"epoch {epoch}")
                break

            if epoch % cfg.runtime.save_freq == 0 or epoch == max_epoch:
                path = save(epoch)
                if path:
                    logger.info("saved checkpoint %s", path)

        launches = {k.__name__: k.launches - launches0[k.__name__] for k in KERNELS}
        logger.info("kernel launches: %s", json.dumps(launches))
        return state
    finally:
        if profiler is not None:
            profiler.stop()
        if metrics_writer is not None:
            metrics_writer.close()
        loader.close()
