"""RAFT fine-tuning CLI of the PyTorch/CUDA port (the JAX package's
`main_raft.py`, the counterpart of the original RAFT train.py):

    python -m pixflow_tpu_torch.main_raft --stage chairs \\
        --chairs-root data/FlyingChairs_release --num-steps 120000 \\
        --batch-size 8 --lr 4e-4 --output-dir out/raft

The flags are the JAX CLI's, plus `--device` (default `cuda`; `--device
cpu` runs on the CPU; a missing card is an error). Stages follow the
standard curriculum (chairs -> things -> sintel / kitti). The batches
equal the JAX CLI's on the same data and seed: the sample indices come from
`np.random.default_rng(seed)`, each sample's augmentation from
`random.Random(seed * 1_000_003 + (step - 1) * batch + j)`, and a resumed
run fast-forwards the index stream past the steps already taken.

Files in `--output-dir`: `raft_<stage>_<step>.pth`, a state_dict under the
reference's RAFT names (what `--restore`, `--flow_model` of the pretraining
CLI and `precompute_flows --flow-model` read); `raft_state.pth`, the full
state (weights, Adam moments, counts) for `--resume` / `--resume auto`;
`raft_metrics.jsonl`; with `--validate`, `raft_val.jsonl`. The run's last
line counts the launches of the correlation lookup's kernels (K2's grid
entry and its backward).

Data parallel, one process a card: `torchrun --nproc_per_node N -m
pixflow_tpu_torch.main_raft ...`. `--batch-size` is the global batch and
must divide by N: every rank draws the same indices and builds its rows
[r*B/N, (r+1)*B/N) of each batch, with the same per-sample seeds, so the
batches are one process's; the gradients are averaged before the clip.
Rank 0 alone writes files, validates and writes submissions."""

from __future__ import annotations

import argparse
import json
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

STAGE_CROPS = {"chairs": (368, 496), "things": (400, 720),
               "sintel": (368, 768), "kitti": (288, 960)}


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser("pixflow-tpu RAFT fine-tuning (PyTorch/CUDA port)")
    p.add_argument("--stage", default="chairs",
                   choices=["chairs", "things", "sintel", "kitti"])
    p.add_argument("--chairs-root", default="")
    p.add_argument("--things-root", default="")
    p.add_argument("--sintel-root", default="")
    p.add_argument("--kitti-root", default="")
    p.add_argument("--hd1k-root", default="")
    p.add_argument("--small", action="store_true")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--gamma", type=float, default=0.8)
    p.add_argument("--crop-size", nargs=2, type=int, default=None,
                   help="default: stage-standard crop")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-steps", type=int, default=120000)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--clip-norm", type=float, default=1.0)
    p.add_argument("--restore", default="", help="warm-start weights from a RAFT "
                   ".pth state_dict (reference names, this trainer's raft_*.pth "
                   "or an upstream checkpoint); optimizer and schedule start fresh")
    p.add_argument("--resume", default="", help="resume from a full train-state "
                   "file (raft_state.pth: weights + Adam moments + step); 'auto' "
                   "picks it up from --output-dir")
    p.add_argument("--output-dir", default="./output/raft")
    p.add_argument("--print-freq", type=int, default=100)
    p.add_argument("--save-freq", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--validate", default="", choices=["", "chairs", "sintel", "kitti"],
                   help="benchmark validation after every save and at the end")
    p.add_argument("--val-max-samples", type=int, default=None)
    p.add_argument("--submit", default="", choices=["", "sintel", "kitti"],
                   help="write test-set submission files and exit")
    p.add_argument("--submit-out", default="", help="submission output dir")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def sample_batch(dataset, rng: np.random.Generator, step: int, batch_size: int, seed: int,
                 pool: Optional[ThreadPoolExecutor] = None, rows: slice = slice(None)) -> dict:
    """Step `step`'s batch (img1, img2, flow, valid as float32 arrays):
    `batch_size` indices drawn from `rng`, sample j augmented by
    `random.Random(seed * 1_000_003 + (step - 1) * batch_size + j)`, a seed
    unique to (step, sample); `pool` builds the samples in threads. `rows`
    builds only those rows of the batch (a rank's share)."""
    idx = rng.integers(0, len(dataset), batch_size)

    def build(ji):
        j, i = ji
        r = random.Random(seed * 1_000_003 + (step - 1) * batch_size + j)
        return dataset.__getitem__(int(i), r)

    todo = list(enumerate(idx))[rows]
    items = (list(pool.map(build, todo)) if pool is not None
             else [build(ji) for ji in todo])
    return {k: np.stack([s[n] for s in items]).astype(np.float32)
            for n, k in enumerate(("img1", "img2", "flow", "valid"))}


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def main(argv: Optional[Sequence[str]] = None):
    a = parse_args(argv)
    from .parallel import init_distributed, shutdown

    ctx, dev = init_distributed(a.device)
    try:
        _main(a, ctx, dev)
    finally:
        shutdown(ctx)


def _main(a, ctx, dev):
    from .data.raft_datasets import fetch_stage_dataset
    from .models.raft import RAFT, load_raft
    from .ops.kernels import RAFT_TRAIN_KERNELS
    from .parallel import broadcast_module_, use_device
    from .train.driver import to_device
    from .train.raft_trainer import (AdamWState, make_raft_train_step,
                                     raft_optimizer, raft_train_state)
    from .utils.metrics_writer import MetricsWriter

    if a.batch_size % ctx.world_size:
        raise ValueError(f"--batch-size {a.batch_size} does not divide over "
                         f"{ctx.world_size} ranks")
    local = a.batch_size // ctx.world_size
    rows = slice(ctx.rank * local, (ctx.rank + 1) * local)
    say = print if ctx.is_main else (lambda *_, **__: None)
    use_device(dev)
    os.makedirs(a.output_dir, exist_ok=True)
    crop = tuple(a.crop_size) if a.crop_size else STAGE_CROPS[a.stage]
    roots = {"chairs": a.chairs_root, "things": a.things_root, "sintel": a.sintel_root,
             "kitti": a.kitti_root, "hd1k": a.hd1k_root}
    dataset = None
    if a.num_steps > 0 and not a.submit:
        dataset = fetch_stage_dataset(a.stage, roots, crop)
        if len(dataset) == 0:
            raise ValueError(f"no samples for stage {a.stage} under {roots}")
        say(f"training with {len(dataset)} image pairs, crop {crop}")

    if a.restore:
        model = load_raft(a.restore, small=a.small)
    else:
        model = RAFT(small=a.small, generator=torch.Generator().manual_seed(a.seed))
    model = model.to(dev)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True  # fixed crop: search once
    rng = np.random.default_rng(a.seed)

    schedule, tx = raft_optimizer(a.lr, a.num_steps, a.weight_decay, a.clip_norm)
    state = raft_train_state(model, tx)
    step_fn = make_raft_train_step(tx, iters=a.iters, gamma=a.gamma, group=ctx.group)

    # full-state resume (weights + Adam moments + step): a warm restart of a
    # long fine-tune must not warm up again from lr/25 with fresh moments
    state_path = os.path.join(a.output_dir, "raft_state.pth")
    start_step = 0
    resume = state_path if a.resume == "auto" else a.resume
    if resume and os.path.exists(resume):
        payload = torch.load(resume, map_location=dev, weights_only=True)
        model.load_state_dict(payload["model"])
        if set(payload["mu"]) != set(state.opt_state.mu):
            raise ValueError(f"{resume}: Adam moments cover other parameters than "
                             "this model's")
        state.opt_state = AdamWState(int(payload["count"]), payload["mu"], payload["nu"])
        state.step = start_step = int(payload["step"])
        say(f"resumed full train state from {resume} at step {start_step}")
    elif a.resume and a.resume != "auto":
        raise FileNotFoundError(a.resume)
    # the same seed and files give every rank the same weights; rank 0's
    # copy makes sure of it (Adam's moments follow from equal gradients)
    broadcast_module_(model, ctx.group)

    def save_state():
        _save_atomic({"model": model.state_dict(), "mu": state.opt_state.mu,
                      "nu": state.opt_state.nu, "count": state.opt_state.count,
                      "step": state.step}, state_path)

    def run_validation(step):
        if not a.validate:
            return
        from .eval.flow_eval import validate_stage
        m = validate_stage(model, a.validate, roots, max_samples=a.val_max_samples)
        m = {k: float(v) for k, v in m.items()}
        m.update(step=step, split=a.validate)
        say("validation", json.dumps(m))
        with open(os.path.join(a.output_dir, "raft_val.jsonl"), "a") as f:
            f.write(json.dumps(m) + "\n")

    if not ctx.is_main and (a.submit or a.num_steps <= 0):
        return  # rank 0 writes the submission or validates
    if a.submit:
        from .eval.flow_eval import create_kitti_submission, create_sintel_submission
        out = a.submit_out or os.path.join(a.output_dir, f"{a.submit}_submission")
        if a.submit == "sintel":
            create_sintel_submission(model, roots["sintel"], out)
        else:
            create_kitti_submission(model, roots["kitti"], out)
        say(f"wrote {a.submit} submission to {out}")
        return

    if a.num_steps <= 0:  # validation only
        run_validation(0)
        return

    sample_pool = ThreadPoolExecutor(a.num_workers) if a.num_workers > 1 else None

    def next_batch(step):
        return sample_batch(dataset, rng, step, a.batch_size, a.seed, sample_pool, rows)

    writer = (MetricsWriter(a.output_dir, filename="raft_metrics.jsonl")
              if ctx.is_main else None)
    # one batch ahead on one thread: host assembly overlaps the device step
    # and the index stream stays in step order; a resumed run first skips
    # the draws its taken steps consumed
    for _ in range(start_step):
        rng.integers(0, len(dataset), a.batch_size)
    prefetch = ThreadPoolExecutor(1)
    fut = prefetch.submit(next_batch, start_step + 1) if start_step < a.num_steps else None
    launches0 = {k.__name__: k.launches for k in RAFT_TRAIN_KERNELS}
    t0 = time.time()
    try:
        for step in range(start_step + 1, a.num_steps + 1):
            batch = fut.result()
            if step < a.num_steps:
                fut = prefetch.submit(next_batch, step + 1)
            state, metrics = step_fn(state, to_device(batch, dev))
            if step % a.print_freq == 0 or step == start_step + 1:
                m = {k: float(v) for k, v in metrics.items()}
                # this update took schedule(step - 1): the count before it
                m.update(lr=schedule(step - 1),
                         sec_per_step=(time.time() - t0) / (step - start_step))
                say(("step {step}: loss {loss:.4f} epe {epe:.3f} 1px {1px:.3f} "
                     "3px {3px:.3f} 5px {5px:.3f}").format(step=step, **m), flush=True)
                if writer is not None:
                    writer.write(step, m)
            if step % a.save_freq == 0 or step == a.num_steps:
                if ctx.is_main:  # the others wait for the files at the barrier
                    path = os.path.join(a.output_dir, f"raft_{a.stage}_{step}.pth")
                    _save_atomic(model.state_dict(), path)
                    save_state()
                    say(f"saved {path} (+ resumable {state_path})", flush=True)
                    run_validation(step)
                ctx.barrier()
    finally:
        prefetch.shutdown(wait=False, cancel_futures=True)
        if sample_pool is not None:
            sample_pool.shutdown(wait=False, cancel_futures=True)
        if writer is not None:
            writer.close()
    launches = {k.__name__: k.launches - launches0[k.__name__] for k in RAFT_TRAIN_KERNELS}
    say(f"kernel launches: {json.dumps(launches)}", flush=True)


if __name__ == "__main__":
    main()
