"""Where the time of one recipe train step goes on the card.

    python -m pixflow_tpu_torch.profile_step [--recipe NAME] [--steps N] [--trace PATH]
                                             [--plain-kernels] [--batch-size B]
                                             [--use-flow-frames] [--no-flow-up-lazy]
                                             [--live-raft] [--raft-train]

Builds the recipe's trainer (synthetic data from a seed), runs two warm-up
steps, then traces `--steps` telemetry-free steps with `torch.profiler`
(CPU and CUDA activities) and prints one JSON line: host time per step, device
busy time per step, the device's idle share, device time per kernel
family (convolution and matmul, each of the port's CUDA kernels, BatchNorm and
other elementwise work, optimizer), and peak device memory over the warm-up
steps (which include cuDNN's algorithm search) and over the traced ones.
`--plain-kernels` takes every kernel's plain PyTorch version instead.
`--use-flow-frames` profiles the multi-span step (every (span, start)
window of the frame stack), `--no-flow-up-lazy` the materialising flow
path, `--batch-size` overrides the recipe's batch (multi-span holds 2F
crops a sample). `--live-raft` computes the flows in the step with
RAFT-small from the batch's frames (a seeded random checkpoint, written to
a temporary `raft-small.pth`; 8 pairs a RAFT forward, the reference's
per-GPU default). `--raft-train` profiles a RAFT train step instead:
RAFT-basic at the chairs stage's crop (368 x 496), batch 8 (or
`--batch-size`), 12 iterations, AdamW, seeded weights and a random batch
on the card, with PyTorch's TF32 defaults. `--trace` also writes the
Chrome trace."""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from .configs import get_recipe
from .device import resolve_device
from .train import build_trainer, run_steps, synthetic_batch

# device kernel name fragments -> family (first match wins)
FAMILIES = (
    ("pair_sums_bwd", ("pair_sums_bwd_kernel",)),
    ("grid_sample_bwd", ("grid_sample_bwd_kernel",)),
    ("pair_sums", ("pair_sums_kernel",)),
    ("point_sample", ("point_sample_kernel",)),
    ("grid_sample", ("grid_sample_kernel",)),
    ("flow_up_points", ("flow_up_points_kernel",)),
    ("conv_matmul", ("conv", "gemm", "Conv", "xmma", "cutlass", "sm90", "cudnn",
                     "wgrad", "dgrad", "fprop", "implicit")),
    ("optimizer", ("foreach", "multi_tensor")),
    ("reduction", ("reduce", "Reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Elementwise")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--recipe", default="pretrain_bdd100k_2000ep_nframe6")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default="")
    ap.add_argument("--plain-kernels", action="store_true")
    ap.add_argument("--batch-size", type=int, default=0)
    ap.add_argument("--use-flow-frames", action="store_true")
    ap.add_argument("--no-flow-up-lazy", action="store_true")
    ap.add_argument("--live-raft", action="store_true")
    ap.add_argument("--raft-train", action="store_true")
    args = ap.parse_args(argv)
    if args.raft_train:
        return _profile_raft_train(args)
    if args.live_raft:
        with tempfile.TemporaryDirectory(prefix="pixflow_raft_") as tmp:
            from .models.raft import seeded_raft
            path = os.path.join(tmp, "raft-small.pth")
            torch.save(seeded_raft(True, seed=0).state_dict(), path)
            return _profile(args, path)
    return _profile(args, "")


def _profile(args, raft_path: str):
    dev = resolve_device("cuda")
    torch.backends.cudnn.benchmark = True
    cfg = get_recipe(args.recipe)
    cfg.runtime.print_freq = 1_000_000  # step 0 logged, the traced ones not
    if args.batch_size:
        cfg.data.batch_size = args.batch_size
    cfg.flow.use_flow_frames = cfg.flow.use_flow_frames or args.use_flow_frames
    cfg.flow.flow_up_lazy = cfg.flow.flow_up_lazy and not args.no_flow_up_lazy
    if raft_path:
        cfg.flow.use_flow_file, cfg.flow.flow_model = False, raft_path
        cfg.flow.small, cfg.flow.flow_bs = True, 8
    batch = synthetic_batch(cfg, seed=0)
    trainer = build_trainer(cfg, dev, 68, plain_kernels=args.plain_kernels)
    state = {"trainer": trainer}

    def run(n):
        state["trainer"] = run_steps(cfg, [batch], n, dev, trainer=state["trainer"])

    _trace(args, dev, run, {
        "recipe": args.recipe, "plain_kernels": args.plain_kernels,
        "batch": cfg.data.batch_size, "use_flow_frames": cfg.flow.use_flow_frames,
        "flow_up_lazy": cfg.flow.flow_up_lazy, "live_raft": bool(raft_path),
        "flow_bs": cfg.flow.flow_bs if raft_path else None})


def _profile_raft_train(args):
    from .models.raft import RAFT
    from .train.raft_trainer import make_raft_train_step, raft_optimizer, raft_train_state

    dev = resolve_device("cuda")
    torch.backends.cudnn.benchmark = True
    b, (h, w) = args.batch_size or 8, (368, 496)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"img1": 255 * torch.rand(b, h, w, 3, device=dev, generator=g),
             "img2": 255 * torch.rand(b, h, w, 3, device=dev, generator=g),
             "flow": 3 * torch.randn(b, h, w, 2, device=dev, generator=g),
             "valid": torch.ones(b, h, w, device=dev)}
    model = RAFT(small=False, generator=torch.Generator().manual_seed(0)).to(dev)
    _, tx = raft_optimizer(4e-4, 120000, 1e-4)
    state = raft_train_state(model, tx)
    step = make_raft_train_step(tx, iters=12, plain=args.plain_kernels)

    def run(n):
        for _ in range(n):
            step(state, batch)

    _trace(args, dev, run, {"raft_train": "basic", "crop": [h, w], "batch": b, "iters": 12,
                            "plain_kernels": args.plain_kernels})


def _trace(args, dev, run, meta: dict):
    """Two warm-up steps, then run(args.steps) under the profiler;
    prints the JSON line."""
    torch.cuda.reset_peak_memory_stats(dev)
    run(2)
    torch.cuda.synchronize()
    warm_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = 0.0
    fams: dict[str, float] = {}
    intervals = []
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        fams[family(e.name)] = fams.get(family(e.name), 0.0) + dur
        intervals.append((e.time_range.start, e.time_range.end))
    # union of kernel intervals: the device's busy time
    intervals.sort()
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    top = sorted(((e.key, e.device_time_total / args.steps / 1e3, e.count // args.steps)
                  for e in prof.key_averages() if e.device_time_total > 0),
                 key=lambda t: -t[1])[:15]
    if args.trace:
        prof.export_chrome_trace(args.trace)
    n = args.steps
    print(json.dumps({
        **meta, "device": torch.cuda.get_device_name(0),
        "traced_steps": n, "host_ms_per_step": 1e3 * host_s / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / host_s,
        "kernels_per_step": len(kernels) / n,
        "device_ms_per_step_by_family": {k: v / 1e3 / n for k, v in
                                         sorted(fams.items(), key=lambda kv: -kv[1])},
        "top_ops_ms_per_step": [{"op": k, "ms": ms, "calls": c} for k, ms, c in top],
        "peak_mem_gb_warmup": warm_peak / 1e9,
        "peak_mem_gb_traced": torch.cuda.max_memory_allocated(dev) / 1e9,
    }), flush=True)


if __name__ == "__main__":
    main()
