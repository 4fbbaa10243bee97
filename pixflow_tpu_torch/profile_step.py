"""Where the time of one recipe train step goes on the card.

    python -m pixflow_tpu_torch.profile_step [--recipe NAME] [--steps N] [--trace PATH]
                                             [--plain-kernels]

Builds the recipe's trainer (synthetic data from a seed), runs two warm-up
steps, then traces `--steps` telemetry-free steps with `torch.profiler`
(CPU and CUDA activities) and prints one JSON line: host time per step, device
busy time per step, the device's idle share, device time per kernel
family (convolution and matmul, each of the port's CUDA kernels, BatchNorm and
other elementwise work, optimizer), and peak device memory over the warm-up
steps (which include cuDNN's algorithm search) and over the traced ones.
`--plain-kernels` takes every kernel's plain PyTorch version instead.
`--trace` also writes the Chrome trace."""

from __future__ import annotations

import argparse
import json
import time

import torch

from .configs import get_recipe
from .device import resolve_device
from .train import build_trainer, run_steps, synthetic_batch

# device kernel name fragments -> family (first match wins)
FAMILIES = (
    ("pair_sums_bwd", ("pair_sums_bwd_kernel",)),
    ("pair_sums", ("pair_sums_kernel",)),
    ("point_sample", ("point_sample_kernel",)),
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
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cudnn.benchmark = True
    cfg = get_recipe(args.recipe)
    cfg.runtime.print_freq = 1_000_000  # step 0 logged, the traced ones not
    batch = synthetic_batch(cfg, seed=0)
    trainer = build_trainer(cfg, dev, 68, plain_kernels=args.plain_kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = run_steps(cfg, [batch], 2, dev, trainer=trainer)
    torch.cuda.synchronize()
    warm_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer = run_steps(cfg, [batch], args.steps, dev, trainer=trainer)
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
        "recipe": args.recipe, "device": torch.cuda.get_device_name(0),
        "plain_kernels": args.plain_kernels,
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
