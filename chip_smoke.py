#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `pixflow_tpu_torch/csrc`, holds each
against its plain PyTorch version at the recipe's shapes (K1 pair sums and
their backward, with dq alone and with dq and dk, K2 point sampling and its
grid-sample entry at the materialising composition's two read shapes, and
the fused lazy flow_up evaluation, which also times the path it replaced:
the composition through 15 K2 launches), checks one float32 train step
through the kernels against the same step through the plain versions, then
trains the `pretrain_bdd100k_2000ep_nframe6` recipe at full width
(ResNet-50, 224 px, per-card batch 64, K=5 flows of 90 x 160, bf16 autocast
over f32 weights) for 2 warm-up and 10 timed steps on synthetic data made
from a seed, and checks which kernels that run launched. The same recipe
then runs on its other paths: `materialize` (--no-flow_up_lazy: whole
720 x 1280 fields through K2, held against the lazy step in float32),
`multispan_parity_f32` and `multispan` (--use_flow_frames: all 15
(span, start) windows, batch 32). `ddp_parity` then trains the recipe
data-parallel: two spawned ranks on the one card, joined by gloo (NCCL
refuses two ranks on one device: the phase asks it and quotes the
answer), each with its 32 rows of the global batch 64 and its BatchNorm
statistics and gradients reduced over both, for two float32 steps through
the kernels, held against one process at batch 64. RAFT follows, with
seeded random weights (none ship with the repository; its flows carry no meaning):
`kernel_raft_lookup` holds K2's grid-sample entry against the plain gather
at RAFT-small's correlation lookup shapes (720 x 1280 frames, micro-batch
4, every pyramid level), `raft_parity_f32` RAFT small and basic through
the kernel against the plain route, `raft` times their forwards, and
`live_raft` trains the recipe at batch 64 with flows from RAFT-small in
the step (no flow files). RAFT training follows:
`kernel_grid_sample_backward` holds the backward kernel of K2's grid entry
against its plain version at RAFT-basic's chairs-stage lookup (368 x 496,
batch 8) and at a general grid, `raft_train_parity_f32` one RAFT small and
basic train step through the kernels against the plain route, and
`raft_train` trains RAFT-basic's chairs stage at full width from a
synthetic FlyingChairs-layout corpus. Then the `cli` phase trains the
recipe from files: it writes a synthetic BDD100k-shaped corpus (720 x 1280 JPEG
frames, six a video, and .pth flows), times the port's loader alone (also
with the photometric ops left to the card), then runs
`python -m pixflow_tpu_torch.main_pretrain` for two epochs and again with
`--auto-resume` for a third, the same two epochs through
`pixflow_tpu_torch.main_pretrain_multihost` as a group of one on NCCL
(`ddp_nccl`: torchrun's variables, a save and an `--auto-resume`, held
against the one-process run), one epoch multi-span with `--device-aug`
and `--mask-ratio-exact`, runs `python -m pixflow_tpu_torch.precompute_flows`
over 8 videos and one epoch of live RAFT-small through the CLI, and checks
the logged metrics, the checkpoints, the kernel launches and the
step-exact resume; last, `cli_eval` runs `main_raft` (a save,
`--resume auto`, `--validate chairs`, its weights through
`precompute_flows`), `main_linear` at ResNet-50, 224 px, batch 256 from the
`cli` run's checkpoint (2 epochs, then `-e --auto-resume`) and
`convert_pretrain_to_d2`. Each path's launches are
counted from 0 just before it runs and read just after.
Each phase prints one JSON line; then come the `kernels` line, the card's
`nvidia-smi` name and power limit, and last `{"ok": true, "device": ...}`.
Any failed check raises: no `ok` line and a non-zero exit. Without a CUDA
device it exits non-zero at once."""

import copy
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

RECIPE = "pretrain_bdd100k_2000ep_nframe6"
STEPS_PER_EPOCH = 68        # BDD100k nframe6 at global batch 1024, as bench.py
REPO = os.path.dirname(os.path.abspath(__file__))
CLI_VIDEOS = 4 * 64         # the cli phase's corpus: 4 steps an epoch at batch 64
CLI_FRAME_HW = (720, 1280)  # BDD100k's frames
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peaks
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


_side_stream = []


def cuda_ms(fn, iters=50) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph and
    replayed between CUDA events, so the host's launch cost (Python,
    ctypes, the caching allocator) is out of the measurement. The warm-up
    runs on one side stream for every call: cuBLAS keeps a workspace for
    each stream it has run on, which would count in the recipe's peak."""
    if not _side_stream:
        _side_stream.append(torch.cuda.Stream())
    side = _side_stream[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=100) -> float:
    """Wall time of one call as a caller sees it: launch cost included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# --- phase 2: kernels against their plain versions --------------------------

def bf16_ulp(x):
    x = x.float()
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def grad_off(got, want, mag) -> int:
    """Elements of a gradient outside its tolerance against the plain
    version's: f32 rtol 1e-5, atol 1e-6 max|want|; bf16 one bf16 ulp of the
    plain result, or of `mag` (the sum of the element's terms' magnitudes)
    where that is larger, since where terms cancel, another summation order
    leaves another residue."""
    check(got.dtype == want.dtype and got.shape == want.shape, "gradient dtype/shape differ")
    w, err = want.float(), (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        allowed = 1e-5 * w.abs() + 1e-6 * float(w.abs().max())
    else:
        allowed = torch.maximum(bf16_ulp(w), bf16_ulp(mag))
    return int((err > allowed).sum())


def compare_pair_sums(dev, batch):
    from pixflow_tpu_torch.ops.flow_points import LazyFlowUp
    from pixflow_tpu_torch.ops.kernels import (fused_pair_sums, pair_mask, pair_sums,
                                               pair_sums_backward, pair_sums_backward_plain,
                                               pair_sums_plain)
    from pixflow_tpu_torch.ops.loss import fused_pair_geometry

    b, n, c = batch["coord1"].shape[0], 49, 256
    fwd = batch["flows_fwd"].transpose(0, 1).contiguous()
    bwd = batch["flows_bwd"].transpose(0, 1).contiguous()
    geom = fused_pair_geometry(batch["coord1"], batch["coord2"], (7, 7),
                               LazyFlowUp(fwd, bwd, 0.01, 0.5))
    gen = torch.Generator(device=dev).manual_seed(0)
    # features of neighbouring bins share a per-sample component, so the
    # positive-pair logits are large and of one sign, as in training
    base = torch.randn(b, 1, c, device=dev, generator=gen)
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)
    q32 = unit(base + 0.7 * torch.randn(b, n, c, device=dev, generator=gen))
    k32 = unit(base + 0.7 * torch.randn(b, n, c, device=dev, generator=gen))
    geom_bytes = 5 * b * n * 4 + b * 4
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        before = pair_sums.launches
        q, k = q32.to(dtype).contiguous(), k32.to(dtype).contiguous()
        got = pair_sums(q, k, *geom, 0.7)
        want = pair_sums_plain(q, k, *geom, 0.7)
        again = pair_sums(q, k, *geom, 0.7)
        torch.cuda.synchronize()
        check(torch.equal(got[:, 1], want[:, 1]), "pair_sums: mask sums differ")
        check(float(want[:, 1].min()) > 0, "pair_sums: a sample has no positive pair")
        err = float((got[:, 0] - want[:, 0]).abs().max())
        check(err <= 1e-5 * float(want[:, 0].abs().max()),
              f"pair_sums {dtype}: logit sums differ by {err}")
        check(torch.equal(got, again), "pair_sums: two runs differ")

        nnz = float(want[:, 1].sum())
        elt = q.element_size()
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        mask_ops_s = 8 * b * n * n / F32_OPS_PER_S
        bytes_ = 2 * b * n * c * elt + geom_bytes + b * 2 * 4
        ops_s = 2 * c * nnz / peak + mask_ops_s
        entry = dict(
            max_abs_err=err, kernel_ms=cuda_ms(lambda: pair_sums(q, k, *geom, 0.7)),
            host_ms=host_ms(lambda: pair_sums(q, k, *geom, 0.7)),
            plain_ms=cuda_ms(lambda: pair_sums_plain(q, k, *geom, 0.7)),
            bound_ms=max(bytes_ / HBM_BYTES_PER_S, ops_s) * 1e3,
            bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= ops_s else "operations",
            library_ms=None, positive_pairs=nnz,
            launches=pair_sums.launches - before)

        # the backward at the cotangent the loss gives: -2 / (B (msum + 1e-6))
        g = (-2.0 / (b * (want[:, 1] + 1e-6))).contiguous()
        gm = g[:, None, None] * pair_mask(*geom, 0.7)
        qf, kf = q.float(), k.float()
        for mode, need_dk in (("dq", False), ("dq_dk", True)):
            before = pair_sums_backward.launches
            run = lambda: pair_sums_backward(q, k, *geom, g, 0.7, True, need_dk)
            plain = lambda: pair_sums_backward_plain(q, k, *geom, g, 0.7, True, need_dk)
            got_b, want_b, again_b = run(), plain(), run()
            # |g M x_t| summed: the plain backward on magnitudes
            mag_b = pair_sums_backward_plain(q.abs(), k.abs(), *geom, g.abs(), 0.7, True,
                                             need_dk)
            torch.cuda.synchronize()
            outs = [(a, w, r) for a, w, r in zip(got_b, want_b, again_b) if w is not None]
            check(len(outs) == 1 + need_dk and (need_dk or got_b[1] is None),
                  f"pair_sums_backward {mode}: wrong outputs")
            off = sum(grad_off(a, w, m) for (a, w, _), m in zip(outs, mag_b))
            check(off == 0, f"pair_sums_backward {dtype} {mode}: {off} elements off")
            check(all(torch.equal(a, r) for a, _, r in outs), "pair_sums_backward: two runs differ")
            if need_dk:  # the two bmm calls alone, M given
                lib = lambda: (torch.bmm(gm, kf), torch.bmm(gm.transpose(1, 2), qf))
            else:
                lib = lambda: torch.bmm(gm, kf)
            bytes_ = (1 + need_dk) * 2 * b * n * c * elt + geom_bytes + b * 4
            ops_s = (1 + need_dk) * 2 * c * nnz / peak + mask_ops_s
            entry[f"backward_{mode}"] = dict(
                max_abs_err=max(float((a.float() - w.float()).abs().max()) for a, w, _ in outs),
                elements_bit_differ=sum(int((a != w).sum()) for a, w, _ in outs),
                kernel_ms=cuda_ms(run), host_ms=host_ms(run), plain_ms=cuda_ms(plain),
                bound_ms=max(bytes_ / HBM_BYTES_PER_S, ops_s) * 1e3,
                bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= ops_s else "operations",
                library_ms=cuda_ms(lib), launches=pair_sums_backward.launches - before)

        # through autograd: the kernel halves against the plain halves
        grads = []
        for plain in (False, True):
            qg, kg = q.clone().requires_grad_(), k.clone().requires_grad_()
            fused_pair_sums(qg, kg, *geom, 0.7, plain=plain)[:, 0].sum().backward()
            grads.append((qg.grad, kg.grad))
        mag = pair_sums_backward_plain(q.abs(), k.abs(), *geom, torch.ones_like(g), 0.7)
        off = sum(grad_off(a, w, m) for a, w, m in zip(*grads, mag))
        check(off == 0, f"fused_pair_sums {dtype}: {off} gradient elements off")
        results[str(dtype).replace("torch.", "")] = entry
    emit({"phase": "kernel_pair_sums", "shape": [b, n, c], **results})
    return results


def compare_point_sample(dev, batch):
    import torch.nn.functional as F
    from pixflow_tpu_torch.ops.kernels import composite_weights_1d, point_sample, point_sample_plain

    field = batch["flows_fwd"][:, 0].contiguous()  # [B, 90, 160, 2]
    b, h, w, c = field.shape
    n = 196
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for up in (1, 8):
        before = point_sample.launches
        # points over the (up*h, up*w) grid and a margin outside it
        u = torch.rand(b, n, 2, device=dev, generator=gen)
        pts = torch.stack([u[..., 0] * (up * w + 8) - 5, u[..., 1] * (up * h + 8) - 5],
                          dim=-1).contiguous()
        check(bool(((pts[..., 0] < 0) | (pts[..., 0] > up * w - 1)).any()),
              "point_sample: no out-of-bounds point")
        got = point_sample(field, pts, up)
        want = point_sample_plain(field, pts, up)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= 1e-5, f"point_sample up={up}: max abs err {err}")

        taps = ((composite_weights_1d(pts[..., 1], up * h, h) != 0).sum(-1)
                * (composite_weights_1d(pts[..., 0], up * w, w) != 0).sum(-1))
        read = min(float(taps.sum()) * c * 4, field.numel() * 4)
        bytes_ = read + pts.numel() * 4 + got.numel() * 4
        ops_s = float(taps.sum()) * c * 2 / F32_OPS_PER_S
        entry = dict(max_abs_err=err, kernel_ms=cuda_ms(lambda: point_sample(field, pts, up)),
                     host_ms=host_ms(lambda: point_sample(field, pts, up)),
                     plain_ms=cuda_ms(lambda: point_sample_plain(field, pts, up)),
                     bound_ms=max(bytes_ / HBM_BYTES_PER_S, ops_s) * 1e3,
                     bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= ops_s else "operations",
                     library_ms=None)
        if up == 1:
            # one PyTorch call computes the same function: timed, never used
            nchw = field.permute(0, 3, 1, 2).contiguous()
            grid = torch.stack([2.0 * pts[..., 0] / (w - 1) - 1.0,
                                2.0 * pts[..., 1] / (h - 1) - 1.0], -1)[:, :, None]
            lib = lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                        padding_mode="zeros", align_corners=True)
            lib_err = float((lib()[..., 0].permute(0, 2, 1) - want).abs().max())
            check(lib_err <= 1e-4, f"grid_sample disagrees with the plain version: {lib_err}")
            entry["library_ms"] = cuda_ms(lib)
        entry["launches"] = point_sample.launches - before
        results[f"up{up}"] = entry
    results["grid_sample"] = compare_grid_sample(dev, batch)
    emit({"phase": "kernel_point_sample", "field": [b, h, w, c], "points": [b, n],
          **results})
    return results


def compare_grid_sample(dev, batch):
    """K2's grid-sample entry at the materialising composition's two read
    shapes, on the recipe's flows: a 1/8-res field [64, 90, 160, 2] read at
    its 14400 pixels advected by one flow (composition without --flow_up),
    and a full-res field [64, 720, 1280, 2] read at its 921600 pixels
    (--flow_up). Held against the plain gather (`resample.grid_sample`),
    whose op order it repeats, and timed beside `F.grid_sample`."""
    import torch.nn.functional as F
    from pixflow_tpu_torch.ops import resample
    from pixflow_tpu_torch.ops.kernels import grid_sample

    flows = batch["flows_fwd"]  # [B, 5, 90, 160, 2]
    shapes = {"flow_1_8": (flows[:, 1].contiguous(), flows[:, 0]),
              "flow_up": (resample.upflow8(flows[:, 1]).contiguous(),
                          resample.upflow8(flows[:, 0]))}
    results = {}
    for name, (field, first) in shapes.items():
        b, h, w, c = field.shape
        base = resample.coords_grid(h, w, device=dev)[None]
        grid = resample.normalize_coords(base + first, h, w).contiguous()
        before = grid_sample.launches
        got = grid_sample(field, grid)
        want = resample.grid_sample(field, grid)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        differ = int((got != want).sum())
        check(differ == 0, f"grid_sample {name}: {differ} elements differ from the gather")

        # taps with a nonzero weight inside the field: what the read needs
        x = ((grid[..., 0] + 1.0) * 0.5 * (w - 1))
        y = ((grid[..., 1] + 1.0) * 0.5 * (h - 1))
        taps = 0.0
        for xc, wx in ((torch.floor(x), 1.0 - (x - torch.floor(x))),
                       (torch.floor(x) + 1.0, x - torch.floor(x))):
            for yc, wy in ((torch.floor(y), 1.0 - (y - torch.floor(y))),
                           (torch.floor(y) + 1.0, y - torch.floor(y))):
                inside = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
                taps += float((inside & (wx * wy != 0)).sum())
        n = grid.shape[1] * grid.shape[2]
        bytes_ = min(taps * c * 4, field.numel() * 4) + grid.numel() * 4 + got.numel() * 4
        ops_s = taps * c * 2 / F32_OPS_PER_S
        nchw = field.permute(0, 3, 1, 2).contiguous()
        lib = lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                    align_corners=True)
        lib_err = float((lib().permute(0, 2, 3, 1) - want).abs().max())
        check(lib_err <= 1e-3, f"F.grid_sample disagrees with the gather: {lib_err}")
        entry = dict(field=[b, h, w, c], points=[b, n], max_abs_err=err,
                     elements_differ=differ, taps=taps,
                     kernel_ms=cuda_ms(lambda: grid_sample(field, grid), iters=20),
                     host_ms=host_ms(lambda: grid_sample(field, grid), iters=20),
                     plain_ms=cuda_ms(lambda: resample.grid_sample(field, grid), iters=3),
                     bound_ms=max(bytes_ / HBM_BYTES_PER_S, ops_s) * 1e3,
                     bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= ops_s else "operations",
                     library_ms=cuda_ms(lib, iters=20), library_max_abs_err=lib_err,
                     launches=grid_sample.launches - before)
        if name == "flow_1_8":
            # the JAX package's dispatch for this shape, the tent
            # contractions: the plain form a CPU run follows
            tent = resample.grid_sample_auto(field, grid)
            entry["tent_max_abs_err"] = float((tent - want).abs().max())
            entry["tent_elements_differ"] = int((tent != want).sum())
        results[name] = entry
    return results


def compare_flow_up_points(dev, batch):
    from pixflow_tpu_torch.configs import get_recipe
    from pixflow_tpu_torch.ops.flow_points import mask_grid
    from pixflow_tpu_torch.ops.kernels import (composite_weights_1d, cycle_mask_points,
                                               cycle_mask_points_plain, flow_up_points,
                                               flow_up_points_plain, point_sample)
    from pixflow_tpu_torch.ops.kernels.flow_up_points import sample_up_plain
    from pixflow_tpu_torch.ops.loss import bin_centers
    from pixflow_tpu_torch.train.train_step import MASK_RATIO_STRIDE

    flow = get_recipe(RECIPE).flow
    fwd = batch["flows_fwd"].transpose(0, 1).contiguous()  # [5, 64, 90, 160, 2]
    bwd = batch["flows_bwd"].transpose(0, 1).contiguous()
    k, b, h, w, _ = fwd.shape
    coord = batch["coord1"]
    x, y = (t.reshape(b, -1).contiguous() for t in bin_centers(coord, (7, 7)))
    modes = {
        # one direction of the train step: 49 bin centers per sample
        "warp": (flow_up_points, flow_up_points_plain,
                 (fwd, bwd, x, y, coord[:, 8], coord[:, 9], flow.alpha1, flow.alpha2, False)),
        # the telemetry: the cycle mask on every 32nd fine pixel
        "mask": (cycle_mask_points, cycle_mask_points_plain,
                 (fwd, bwd, mask_grid(b, h, w, MASK_RATIO_STRIDE, dev), flow.alpha1,
                  flow.alpha2, False)),
    }
    results = {}
    for mode, (kern, plain, args) in modes.items():
        before = flow_up_points.launches
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        launches = flow_up_points.launches - before
        got, want = (list(v) if mode == "warp" else [v] for v in (got, want))
        entry = {"points": list(got[-1].shape), "launches": launches}
        m_got, m_want = got[-1], want[-1]
        entry["mask_entries_differ"] = int((m_got != m_want).sum())
        entry["mask_agreement"] = float((m_got == m_want).float().mean())
        entry["trusted_share"] = float(m_want.mean())
        check(launches == 1, f"flow_up_points {mode}: {launches} launches for one call")
        check(entry["mask_agreement"] >= 0.995, f"flow_up_points {mode}: masks agree "
              f"on {entry['mask_agreement']}")
        if mode == "warp":
            diff = torch.maximum((got[0] - want[0]).abs(), (got[1] - want[1]).abs())
            entry["max_abs_err"] = float(diff.max())
            entry["positions_bit_equal"] = int(((got[0] == want[0]) & (got[1] == want[1])).sum())
            check(entry["max_abs_err"] <= 1e-3,
                  f"flow_up_points: positions differ by {entry['max_abs_err']} px")
        else:
            entry["max_abs_err"] = float((m_got - m_want).abs().max())

        # the taps this run's trajectories read, from the plain composition
        taps = [0.0]

        def counting(coarse, pts):
            n = ((composite_weights_1d(pts[..., 1], 8 * h, h) != 0).sum(-1)
                 * (composite_weights_1d(pts[..., 0], 8 * w, w) != 0).sum(-1))
            taps[0] += float(n.sum())
            return sample_up_plain(coarse, pts)

        plain(*args, sampler=counting)
        inputs = sum(t.numel() * 4 for t in args if isinstance(t, torch.Tensor)
                     and t is not fwd and t is not bwd)
        bytes_ = (min(taps[0] * 2 * 4, (fwd.numel() + bwd.numel()) * 4) + inputs
                  + sum(t.numel() * 4 for t in got))
        ops_s = taps[0] * 2 * 2 / F32_OPS_PER_S
        # the path this kernel replaced: the same composition, its U(f) reads
        # through K2 (15 launches per direction in warp mode) and its small ops
        k2_path = lambda: plain(*args, sampler=lambda c_, p_: point_sample(c_, p_, 8))
        entry.update(
            taps=taps[0],
            kernel_ms=cuda_ms(lambda: kern(*args)), host_ms=host_ms(lambda: kern(*args)),
            plain_ms=cuda_ms(lambda: plain(*args), iters=10),
            k2_path_ms=cuda_ms(k2_path, iters=10), k2_path_host_ms=host_ms(k2_path, iters=10),
            bound_ms=max(bytes_ / HBM_BYTES_PER_S, ops_s) * 1e3,
            bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= ops_s else "operations",
            library_ms=None)
        results[mode] = entry

    # PyTorch's CUDA division by a Python number multiplies by its float32
    # reciprocal; the plain composition writes that product out
    v = torch.rand(1 << 20, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    v = v * 1400.0 - 50.0
    torch.cuda.synchronize()
    scalar = v / 1279
    results["scalar_division"] = {
        "values": v.numel(),
        "differ_from_true_division": int((scalar != v / torch.full((), 1279.0, device=dev)).sum()),
        "differ_from_reciprocal_product": int((scalar != v * float(np.float32(1) / np.float32(1279))).sum())}
    emit({"phase": "kernel_flow_up_points", "flows": [k, b, h, w, 2], **results})
    return results


# --- phase 3: one f32 step through the kernels vs the plain versions ---------

def step_parity(dev):
    from pixflow_tpu_torch.configs import get_recipe
    from pixflow_tpu_torch.models import init_momentum_from_online
    from pixflow_tpu_torch.ops.kernels import pair_sums, pair_sums_backward
    from pixflow_tpu_torch.train import build_model, build_trainer, run_steps, synthetic_batch

    torch.backends.cudnn.deterministic = True  # identical convolutions in both runs
    cfg = get_recipe(RECIPE)
    cfg.data.batch_size = 8
    cfg.runtime.compute_dtype = "float32"
    batch = synthetic_batch(cfg, seed=2)
    model = build_model(cfg, dev)
    init_momentum_from_online(model)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs, k1_launches = {}, {}
    for plain in (False, True):
        m = copy.deepcopy(model)
        tr = build_trainer(cfg, dev, STEPS_PER_EPOCH, model=m, plain_kernels=plain)
        counts = [kern.launches for kern in (pair_sums, pair_sums_backward)]
        tr = run_steps(cfg, [batch], 1, dev, trainer=tr)
        k1_launches["plain" if plain else "kernel"] = [
            kern.launches - n for kern, n in zip((pair_sums, pair_sums_backward), counts)]
        runs[plain] = (tr.history[0], tr.state.model.state_dict())
    torch.backends.cudnn.deterministic = False
    (mk, sk), (mp, sp) = runs[False], runs[True]

    loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    pos_diff = {key: abs(mk[key] - mp[key]) / max(mp[key], 1.0)
                for key in ("pos_num_1", "pos_num_2")}
    bufs = [n for n, _ in model.named_buffers()]
    stats_err = max(rel(sk[n], sp[n]) for n in bufs)
    upd_err = max(rel(sk[n] - before[n], sp[n] - before[n])
                  for n, _ in model.named_parameters()
                  if not n.split(".")[0].endswith("_k"))
    emit({"phase": "step_parity_f32", "batch": 8, "tf32": False,
          "loss_kernel": mk["loss"], "loss_plain": mp["loss"], "loss_rel_diff": loss_rel,
          "pos_num_kernel": [mk["pos_num_1"], mk["pos_num_2"]],
          "pos_num_plain": [mp["pos_num_1"], mp["pos_num_2"]],
          "pos_num_rel_diff": pos_diff, "bn_stats_max_rel_err": stats_err,
          "param_update_max_rel_err": upd_err,
          "mask_ratio_fwd": [mk["mask_ratio_fwd"], mp["mask_ratio_fwd"]],
          "k1_launches_fwd_bwd": k1_launches})
    # the kernel run through both K1 kernels, once per direction; the
    # comparison run through neither
    check(k1_launches == {"kernel": [2, 2], "plain": [0, 0]},
          f"K1 launches in the parity runs: {k1_launches}")
    check(math.isfinite(mk["loss"]) and loss_rel <= 1e-4, f"step loss differs by {loss_rel}")
    check(all(d <= 5e-3 for d in pos_diff.values()), f"pos_num differs: {pos_diff}")
    check(mk["pos_num_1"] > 0 and mk["pos_num_2"] > 0, "no positive pairs")
    # BN statistics come from the convolutions alone; parameter updates see
    # the kernels through the loss (f32 sums in another order)
    check(stats_err <= 1e-6, f"BN statistics differ: {stats_err}")
    check(upd_err <= 1e-3, f"parameter updates differ: {upd_err}")


# --- phase 4: the recipe ------------------------------------------------------

def recipe_run(dev):
    from pixflow_tpu_torch.configs import get_recipe
    from pixflow_tpu_torch.ops.kernels import KERNELS
    from pixflow_tpu_torch.train import build_trainer, run_steps, synthetic_batch

    torch.backends.cudnn.benchmark = True
    cfg = get_recipe(RECIPE)
    cfg.runtime.print_freq = 10  # flow telemetry on steps 0 and 10
    batches = [synthetic_batch(cfg, seed=s) for s in (10, 11)]
    trainer = build_trainer(cfg, dev, STEPS_PER_EPOCH)
    torch.cuda.reset_peak_memory_stats(dev)

    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    trainer = run_steps(cfg, batches, 2, dev, trainer=trainer)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(10):
        t = time.perf_counter()
        trainer = run_steps(cfg, batches, 1, dev, trainer=trainer)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {kern.__name__: kern.launches for kern in KERNELS}

    b = cfg.data.batch_size
    logged = trainer.history
    for m in logged:
        check(math.isfinite(m["loss"]), f"non-finite loss at step {m['step']}")
        check(m["pos_num"] > 0, f"no positive pairs at step {m['step']}")
        check(0.0 <= m["mask_ratio_fwd"] <= 0.5, f"mask ratio {m['mask_ratio_fwd']}")
    check(all(bool(torch.isfinite(p).all()) for p in trainer.state.model.parameters()),
          "non-finite parameters after the run")
    n_tele = len(logged)
    # one flow_up_points launch per direction, one more per direction for the
    # telemetry of a logged step; K2 itself is off the path
    expect = {"pair_sums": 2 * 12, "pair_sums_backward": 2 * 12, "point_sample": 0,
              "flow_up_points": 2 * 12 + 2 * n_tele, "grid_sample": 0}
    check(launches == expect, f"kernel launches {launches}, expected {expect}")
    total = sum(times)
    emit({"phase": "recipe", "recipe": RECIPE, "arch": cfg.model.arch,
          "batch": b, "image_size": cfg.data.image_size, "flows": [5, 90, 160],
          "compute_dtype": cfg.runtime.compute_dtype, "timed_steps": len(times),
          "telemetry_steps_timed": sum(1 for m in logged if m["step"] >= 2),
          "warmup_s": warm_s, "step_ms": 1e3 * total / len(times),
          "step_ms_median": 1e3 * float(np.median(times)),
          "step_ms_max": 1e3 * max(times), "img_per_s": b * len(times) / total,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "launches": launches, "logged": logged, "card": nvidia_smi()})
    return launches, 1e3 * float(np.median(times))


# --- phase 5: the materialising flow path ------------------------------------

def _recipe_cfg(**flow):
    from pixflow_tpu_torch.configs import get_recipe
    cfg = get_recipe(RECIPE)
    for k, v in flow.items():
        setattr(cfg.flow, k, v)
    return cfg


def _timed_steps(cfg, dev, batches, warm, timed, trainer):
    """(trainer, step seconds, launches of every kernel over the timed and
    warm-up steps, peak bytes): counts set to 0 just before, read just
    after."""
    from pixflow_tpu_torch.ops.kernels import KERNELS
    from pixflow_tpu_torch.train import run_steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kern in KERNELS:
        kern.launches = 0
    trainer = run_steps(cfg, batches, warm, dev, trainer=trainer)
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer = run_steps(cfg, batches, 1, dev, trainer=trainer)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {kern.__name__: kern.launches for kern in KERNELS}
    return trainer, times, launches, torch.cuda.max_memory_allocated(dev)


def materialize_run(dev):
    """The recipe at batch 64 with --no-flow_up_lazy: K=5 flows upsampled to
    720 x 1280 and composed as whole fields, full-res cycle masks, all reads
    through K2's grid-sample entry. One f32 step against the lazy step on
    the same batch and weights, at the JAX package's lazy-vs-materialising
    bounds (tests/test_flow_points.py: positions rtol 1e-4, atol 2e-3 px,
    masks agree on 99.5%, loss rtol 1e-4); then timed bf16 steps and the
    exact mask ratio against the strided estimate."""
    from pixflow_tpu_torch.models import init_momentum_from_online
    from pixflow_tpu_torch.ops.flow import compose_and_mask
    from pixflow_tpu_torch.ops.flow_points import LazyFlowUp, flow_up_warp_points
    from pixflow_tpu_torch.ops.flow_points import mask_ratio_estimate
    from pixflow_tpu_torch.ops.loss import bin_centers, warp_points_with_flow
    from pixflow_tpu_torch.train import (build_model, build_trainer, run_steps,
                                         synthetic_batch, to_device)
    from pixflow_tpu_torch.train.driver import _exact_mask_ratio_fn
    from pixflow_tpu_torch.train.train_step import MASK_RATIO_STRIDE

    cfg = _recipe_cfg(flow_up_lazy=False)
    flow = cfg.flow
    batch = to_device(synthetic_batch(cfg, seed=20), dev)
    b = cfg.data.batch_size

    # the geometry: materialised field + mask read at the bin centers
    # against the lazy evaluation at the same points
    with torch.no_grad():
        ff, _, mf, _ = compose_and_mask(batch["flows_fwd"], batch["flows_bwd"], flow_up=True,
                                        alpha_1=flow.alpha1, alpha_2=flow.alpha2)
        x, y = bin_centers(batch["coord1"], (7, 7))
        orig = (batch["coord1"][:, 9], batch["coord1"][:, 8])
        rx, ry, rm = warp_points_with_flow(ff, x, y, orig, mf)
        lf = LazyFlowUp(batch["flows_fwd"].transpose(0, 1).contiguous(),
                        batch["flows_bwd"].transpose(0, 1).contiguous(),
                        flow.alpha1, flow.alpha2)
        lx, ly, lm = flow_up_warp_points(lf, x, y, orig)
        del ff, mf
    pos_err = torch.maximum((lx - rx).abs() - 1e-4 * rx.abs(),
                            (ly - ry).abs() - 1e-4 * ry.abs())
    geometry = {"max_abs_err_px": float(torch.maximum((lx - rx).abs(), (ly - ry).abs()).max()),
                "points_beyond_tolerance": int((pos_err > 2e-3).sum()),
                "mask_agreement": float((lm == rm).float().mean())}
    check(geometry["points_beyond_tolerance"] == 0, f"materialised vs lazy points: {geometry}")
    check(geometry["mask_agreement"] >= 0.995, f"materialised vs lazy masks: {geometry}")

    # one f32 step, materialising against lazy, same batch and weights
    torch.backends.cudnn.deterministic = True
    f32 = copy.deepcopy(cfg)
    f32.runtime.compute_dtype = "float32"
    model = build_model(f32, dev)
    init_momentum_from_online(model)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    runs = {}
    for lazy in (False, True):
        c = copy.deepcopy(f32)
        c.flow.flow_up_lazy = lazy
        tr = build_trainer(c, dev, STEPS_PER_EPOCH, model=copy.deepcopy(model))
        tr = run_steps(c, [batch], 1, dev, trainer=tr)
        runs[lazy] = (tr.history[0], tr.state.model.state_dict())
        del tr
    del model
    torch.backends.cudnn.deterministic = False
    (mm, sm), (ml, sl) = runs[False], runs[True]
    loss_diff = abs(mm["loss"] - ml["loss"])
    pos_diff = {k: abs(mm[k] - ml[k]) / max(ml[k], 1.0) for k in ("pos_num_1", "pos_num_2")}
    upd_err = max(rel(sm[n] - before[n], sl[n] - before[n]) for n in before
                  if not n.split(".")[0].endswith("_k"))
    parity = {"loss_materialize": mm["loss"], "loss_lazy": ml["loss"], "loss_abs_diff": loss_diff,
              "pos_num_materialize": [mm["pos_num_1"], mm["pos_num_2"]],
              "pos_num_lazy": [ml["pos_num_1"], ml["pos_num_2"]],
              "pos_num_equal": mm["pos_num"] == ml["pos_num"], "pos_num_rel_diff": pos_diff,
              "param_update_max_rel_err": upd_err,
              "mask_ratio_materialize": [mm["mask_ratio_fwd"], mm["mask_ratio_bwd"]],
              "mask_ratio_lazy_strided": [ml["mask_ratio_fwd"], ml["mask_ratio_bwd"]]}
    del runs, sm, sl, before
    check(loss_diff <= 1e-4 * abs(ml["loss"]) + 1e-5, f"materialised vs lazy loss: {parity}")
    check(all(d <= 5e-3 for d in pos_diff.values()), f"materialised vs lazy pos_num: {parity}")

    # timed bf16 steps
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    trainer = build_trainer(cfg, dev, STEPS_PER_EPOCH)
    steps = 2 + 5
    trainer, times, launches, peak = _timed_steps(cfg, dev, [batch], 2, 5, trainer)
    for m in trainer.history:
        check(math.isfinite(m["loss"]) and m["pos_num"] > 0, f"materialize step {m}")
    # K = 5 reads a direction, one read per cycle mask: 12 a step
    expect = {"pair_sums": 2 * steps, "pair_sums_backward": 2 * steps, "point_sample": 0,
              "flow_up_points": 0, "grid_sample": 12 * steps}
    check(launches == expect, f"materialize launches {launches}, expected {expect}")
    exact = _exact_mask_ratio_fn(cfg)(batch["flows_fwd"], batch["flows_bwd"])
    fwd = batch["flows_fwd"].transpose(0, 1).contiguous()
    bwd = batch["flows_bwd"].transpose(0, 1).contiguous()
    strided = [float(torch.mean(mask_ratio_estimate(a, c, flow.alpha1, flow.alpha2,
                                                    stride=MASK_RATIO_STRIDE)))
               for a, c in ((fwd, bwd), (bwd, fwd))]
    del trainer
    torch.cuda.empty_cache()
    total = sum(times)
    emit({"phase": "materialize", "recipe": RECIPE, "batch": b, "flow_up_lazy": False,
          "geometry_vs_lazy": geometry, "step_f32_vs_lazy": parity,
          "timed_steps": len(times), "step_ms": 1e3 * total / len(times),
          "step_ms_median": 1e3 * float(np.median(times)), "img_per_s": b * len(times) / total,
          "peak_mem_gb": peak / 1e9, "launches": launches,
          "grid_sample_launches_per_step": launches["grid_sample"] / steps,
          "mask_ratio_exact": list(exact), "mask_ratio_strided_estimate": strided,
          "card": nvidia_smi()})
    return launches


# --- phase 6: multi-span -------------------------------------------------------

MULTISPAN_BATCH = 32  # a sample is 2F = 10 encoder crops: the recipe's 64 halved


def multispan_parity(dev):
    """One multi-span step at full width (ResNet-50, 224 px, K=5: 15
    windows), batch 4, f32, TF32 off: through the kernels against through
    their plain versions."""
    from pixflow_tpu_torch.models import init_momentum_from_online
    from pixflow_tpu_torch.ops.kernels import KERNELS
    from pixflow_tpu_torch.train import build_model, build_trainer, run_steps, synthetic_batch

    torch.backends.cudnn.deterministic = True
    cfg = _recipe_cfg(use_flow_frames=True)
    cfg.data.batch_size = 4
    cfg.runtime.compute_dtype = "float32"
    batch = synthetic_batch(cfg, seed=30)
    model = build_model(cfg, dev)
    init_momentum_from_online(model)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs, counts = {}, {}
    for plain in (False, True):
        tr = build_trainer(cfg, dev, STEPS_PER_EPOCH, model=copy.deepcopy(model),
                           plain_kernels=plain)
        for kern in KERNELS:
            kern.launches = 0
        tr = run_steps(cfg, [batch], 1, dev, trainer=tr)
        counts["plain" if plain else "kernel"] = {k.__name__: k.launches for k in KERNELS}
        runs[plain] = (tr.history[0], tr.state.model.state_dict())
    torch.backends.cudnn.deterministic = False
    (mk, sk), (mp, sp) = runs[False], runs[True]
    loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    pos_diff = {k: abs(mk[k] - mp[k]) / max(mp[k], 1.0) for k in ("pos_num_1", "pos_num_2")}
    stats_err = max(rel(sk[n], sp[n]) for n, _ in model.named_buffers())
    upd_err = max(rel(sk[n] - before[n], sp[n] - before[n]) for n, _ in model.named_parameters()
                  if not n.split(".")[0].endswith("_k"))
    emit({"phase": "multispan_parity_f32", "batch": 4, "windows": 15, "tf32": False,
          "loss_kernel": mk["loss"], "loss_plain": mp["loss"], "loss_rel_diff": loss_rel,
          "pos_num_kernel": [mk["pos_num_1"], mk["pos_num_2"]],
          "pos_num_plain": [mp["pos_num_1"], mp["pos_num_2"]], "pos_num_rel_diff": pos_diff,
          "bn_stats_max_rel_err": stats_err, "param_update_max_rel_err": upd_err,
          "launches": counts})
    # 15 windows, one launch of each K1 kernel and of flow_up_points a
    # window and direction, 2 more flow_up_points for the logged step
    check(counts == {"kernel": {"pair_sums": 30, "pair_sums_backward": 30, "point_sample": 0,
                                "flow_up_points": 32, "grid_sample": 0},
                     "plain": dict.fromkeys(counts["plain"], 0)},
          f"multispan parity launches {counts}")
    check(math.isfinite(mk["loss"]) and loss_rel <= 1e-4, f"multispan loss differs by {loss_rel}")
    check(all(d <= 5e-3 for d in pos_diff.values()), f"multispan pos_num differs: {pos_diff}")
    check(mk["pos_num_1"] > 0 and mk["pos_num_2"] > 0, "multispan: no positive pairs")
    check(stats_err <= 1e-6, f"multispan BN statistics differ: {stats_err}")
    check(upd_err <= 1e-3, f"multispan parameter updates differ: {upd_err}")


def multispan_run(dev):
    """The full-width multi-span recipe (K=5: 15 windows, F=5 crops a view)
    at batch MULTISPAN_BATCH: 2 warm-up and 10 timed steps, one of them
    logged (telemetry on the full-span window)."""
    from pixflow_tpu_torch.train import build_trainer, synthetic_batch, to_device

    torch.backends.cudnn.benchmark = True
    cfg = _recipe_cfg(use_flow_frames=True)
    cfg.data.batch_size = b = MULTISPAN_BATCH
    cfg.runtime.print_freq = 10  # steps 0 and 10 logged
    batches = [to_device(synthetic_batch(cfg, seed=s), dev) for s in (40, 41)]
    trainer = build_trainer(cfg, dev, STEPS_PER_EPOCH)
    t0 = time.perf_counter()
    trainer, times, launches, peak = _timed_steps(cfg, dev, batches, 2, 10, trainer)
    wall = time.perf_counter() - t0
    logged = trainer.history
    for m in logged:
        check(math.isfinite(m["loss"]) and m["pos_num"] > 0, f"multispan step {m}")
        check(0.0 <= m["mask_ratio_fwd"] <= 0.5, f"multispan mask ratio {m['mask_ratio_fwd']}")
    check(all(bool(torch.isfinite(p).all()) for p in trainer.state.model.parameters()),
          "multispan: non-finite parameters")
    n = 12
    expect = {"pair_sums": 30 * n, "pair_sums_backward": 30 * n, "point_sample": 0,
              "flow_up_points": 30 * n + 2 * len(logged), "grid_sample": 0}
    check(launches == expect, f"multispan launches {launches}, expected {expect}")
    del trainer, batches
    torch.cuda.empty_cache()
    total = sum(times)
    emit({"phase": "multispan", "recipe": RECIPE, "use_flow_frames": True, "batch": b,
          "crops_per_sample": 2 * (cfg.data.n_frames - 1), "windows": 15,
          "timed_steps": len(times), "warm_and_timed_s": wall,
          "step_ms": 1e3 * total / len(times), "step_ms_median": 1e3 * float(np.median(times)),
          "step_ms_max": 1e3 * max(times), "samples_per_s": b * len(times) / total,
          "peak_mem_gb": peak / 1e9, "launches": launches,
          "launches_per_step": {k: v / n for k, v in launches.items()},
          "logged": logged, "card": nvidia_smi()})
    return launches


# --- phase 6b: data parallelism, two ranks on the one card --------------------

DDP_RANKS = 2
DDP_SEEDS = (50, 51)  # the two steps' global batches


def _ddp_cfg():
    """The recipe at its global batch 64, float32, every step logged."""
    from pixflow_tpu_torch.configs import get_recipe
    cfg = get_recipe(RECIPE)
    cfg.runtime.compute_dtype = "float32"
    cfg.runtime.print_freq = 1
    return cfg


def _ddp_rank(rank, world, port, out_dir, device, cfg_fn):
    """One rank of `ddp_parity` (a spawned process): joins the others by
    gloo on `device`, builds the seeded model with its BatchNorms over the
    group, takes its rows of each global batch for one step each, and saves
    its metrics, step times, the gradient all-reduce's time, its peak
    memory, its kernel launches and its final state."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from pixflow_tpu_torch.models import init_momentum_from_online
    from pixflow_tpu_torch.ops.kernels import KERNELS
    from pixflow_tpu_torch.parallel import (all_reduce_sum_, init_distributed, local_rows,
                                            shutdown, use_device)
    from pixflow_tpu_torch.train import build_model, build_trainer, run_steps, synthetic_batch

    ctx, dev = init_distributed(device, backend="gloo")
    use_device(dev)
    torch.set_num_threads(max(len(os.sched_getaffinity(0)) // world, 1))  # the host is shared
    try:
        cfg = cfg_fn()
        batches = [local_rows(synthetic_batch(cfg, seed=s), rank, world) for s in DDP_SEEDS]
        cfg.data.batch_size //= world  # per rank: the global batch stays the same
        model = build_model(cfg, dev, ctx.group)  # the same seed on every rank
        init_momentum_from_online(model)
        trainer = build_trainer(cfg, dev, STEPS_PER_EPOCH, model=model, ctx=ctx)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for kern in KERNELS:
            kern.launches = 0
        step_s, states = [], []
        for b in batches:
            sync()
            t = time.perf_counter()
            trainer = run_steps(cfg, [b], 1, dev, trainer=trainer)
            sync()
            step_s.append(time.perf_counter() - t)
            states.append({k: v.to("cpu", copy=True)
                           for k, v in trainer.state.model.state_dict().items()})
        launches = {k.__name__: k.launches for k in KERNELS}
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        # the gradient all-reduce alone: one flat buffer of every trainable
        # parameter's gradient, as the step sends it
        grads = [torch.zeros_like(p) for n, p in trainer.state.model.named_parameters()
                 if n in trainer.state.opt_state.momentum]
        reduce_s = []
        for _ in range(3):
            sync()
            t = time.perf_counter()
            all_reduce_sum_(grads, ctx.group)
            sync()
            reduce_s.append(time.perf_counter() - t)
        torch.save({"history": trainer.history, "step_s": step_s, "reduce_s": reduce_s,
                    "peak": peak, "launches": launches,
                    "grad_bytes": sum(g.numel() * g.element_size() for g in grads),
                    "states": states}, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown(ctx)


def _nccl_two_ranks_one_card(rank, port, out_dir):
    """Two NCCL ranks on cuda:0: the first collective's error, if any."""
    import torch.distributed as tdist
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.cuda.set_device(0)
    msg = None
    try:
        tdist.init_process_group("nccl", init_method="env://", rank=rank, world_size=2)
        t = torch.ones(4, device="cuda:0")
        tdist.all_reduce(t)
        torch.cuda.synchronize()
    except Exception as e:  # the answer this probe is for
        msg = f"{type(e).__name__}: {e}"
    with open(os.path.join(out_dir, f"nccl{rank}.txt"), "w") as f:
        f.write(msg or "")
    os._exit(0)  # a refused communicator may not tear down cleanly


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_ranks(fn, args, nprocs, timeout):
    """Run fn(rank, *args) in `nprocs` spawned processes; a rank that
    raises or dies fails the phase, one still running after `timeout` s is
    killed and fails it too."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.time() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
            if time.time() > deadline:
                raise AssertionError(f"{fn.__name__}: ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def ddp_parity(dev, cfg_fn=_ddp_cfg, rank_device="cuda:0", probe_nccl=True):
    """Data parallelism on the one card: two ranks joined by gloo (NCCL
    refuses two ranks on one device: `probe_nccl` asks it and quotes its
    answer), each taking its 32 rows of the recipe's global batch 64 for
    two float32 steps through the kernels, against one process at batch 64
    on the same rows from the same seeded weights, at step_parity_f32's
    tolerances. Both ranks share the card and the host: their step times
    are no multi-card number."""
    from pixflow_tpu_torch.models import init_momentum_from_online
    from pixflow_tpu_torch.train import build_model, build_trainer, run_steps, synthetic_batch

    on_card = dev.type == "cuda"
    cfg = cfg_fn()
    torch.backends.cudnn.deterministic = True
    model = build_model(cfg, dev)
    init_momentum_from_online(model)
    before = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
    trainer = build_trainer(cfg, dev, STEPS_PER_EPOCH, model=model)
    one_s, one_states = [], []
    for s in DDP_SEEDS:
        batch = synthetic_batch(cfg, seed=s)
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        trainer = run_steps(cfg, [batch], 1, dev, trainer=trainer)
        if on_card:
            torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t)
        one_states.append({k: v.to("cpu", copy=True)
                           for k, v in trainer.state.model.state_dict().items()})
    torch.backends.cudnn.deterministic = False
    one_hist = trainer.history
    params = [n for n, _ in model.named_parameters() if not n.split(".")[0].endswith("_k")]
    buffers = [n for n, _ in model.named_buffers()]
    del trainer, model
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pixflow_ddp_") as out_dir:
        _spawn_ranks(_ddp_rank, (DDP_RANKS, _free_port(), out_dir, rank_device, cfg_fn),
                     DDP_RANKS, timeout=300)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(DDP_RANKS)]
        nccl = None
        if probe_nccl:
            try:
                _spawn_ranks(_nccl_two_ranks_one_card, (_free_port(), out_dir), 2, timeout=120)
                nccl = [open(os.path.join(out_dir, f"nccl{r}.txt")).read() or None
                        for r in range(2)]
            except AssertionError as e:
                nccl = [f"no answer: {e}"]
    ranks_s = time.perf_counter() - t0

    r0, r1 = ranks
    hist = r0["history"]
    check(len(hist) == len(one_hist) == len(DDP_SEEDS), f"ddp steps {len(hist)}")
    check(r0["history"] == r1["history"], "ddp: the ranks report different metrics")
    check(all(torch.equal(a[k], b[k]) for a, b in zip(r0["states"], r1["states"]) for k in a),
          "ddp: the ranks' weights differ")
    loss_rel = [abs(m["loss"] - o["loss"]) / abs(o["loss"]) for m, o in zip(hist, one_hist)]
    pos_equal = all(m[k] == o[k] for m, o in zip(hist, one_hist)
                    for k in ("pos_num_1", "pos_num_2"))
    # after each step: BatchNorm statistics, and the updates so far of every
    # online parameter as one vector, of each weight matrix and of each
    # 1-D tensor (BatchNorm scales and biases: sums over a whole batch of
    # terms that cancel, whose rounding differs with the split: reported)
    stats_err, upd_err, matrix_err, vector_err = [], [], [], []
    flat = lambda st: torch.cat([(st[n] - before[n]).reshape(-1).double() for n in params])
    for got, want in zip(r0["states"], one_states):
        stats_err.append(max((rel(got[n], want[n]), n) for n in buffers))
        upd_err.append(rel(flat(got), flat(want)))
        per = {n: rel(got[n] - before[n], want[n] - before[n]) for n in params}
        matrix_err.append(max((e, n) for n, e in per.items() if before[n].dim() > 1))
        vector_err.append(max((e, n) for n, e in per.items() if before[n].dim() == 1))
    per_step = len(DDP_SEEDS)
    expect = {"pair_sums": 2 * per_step, "pair_sums_backward": 2 * per_step,
              "point_sample": 0, "flow_up_points": 4 * per_step, "grid_sample": 0}
    out = {"phase": "ddp_parity", "recipe": RECIPE, "ranks": DDP_RANKS,
           "backend": "gloo (host-staged), two ranks sharing one card",
           "global_batch": cfg.data.batch_size, "batch_per_rank": cfg.data.batch_size // 2,
           "steps": per_step, "compute_dtype": "float32", "tf32": False,
           "loss_ranks": [m["loss"] for m in hist], "loss_one_process": [
               o["loss"] for o in one_hist], "loss_rel_diff": loss_rel,
           "pos_num_ranks": [[m["pos_num_1"], m["pos_num_2"]] for m in hist],
           "pos_num_one_process": [[o["pos_num_1"], o["pos_num_2"]] for o in one_hist],
           "bn_stats_max_rel_err": stats_err, "param_update_rel_err": upd_err,
           "weight_matrix_update_max_rel_err": matrix_err,
           "vector_update_max_rel_err": vector_err,
           "rank_step_ms": [[1e3 * x for x in r["step_s"]] for r in ranks],
           "one_process_step_ms": [1e3 * x for x in one_s],
           "grad_all_reduce_ms": [[1e3 * x for x in r["reduce_s"]] for r in ranks],
           "grad_all_reduce_bytes": r0["grad_bytes"],
           "rank_peak_mem_gb": [r["peak"] / 1e9 if r["peak"] else None for r in ranks],
           "launches_per_rank": [r["launches"] for r in ranks],
           "ranks_wall_s": ranks_s, "nccl_two_ranks_one_card": nccl}
    if on_card:
        out["card"] = nvidia_smi()
    emit(out)
    for r in ranks:
        check(r["launches"] == expect, f"ddp rank launches {r['launches']}, expected {expect}")
    check(all(math.isfinite(m["loss"]) for m in hist), "ddp: non-finite loss")
    check(all(d <= 1e-4 for d in loss_rel), f"ddp loss differs by {loss_rel}")
    check(pos_equal and hist[0]["pos_num"] > 0, "ddp: pos_num differs or is zero")
    # The ranks split every batch sum, so rounding differs where sums
    # cancel: BatchNorm's variance is E[x^2] - E[x]^2 (flax's formula, kept
    # for parity), 1.5e-6 relative on the card where one process's
    # statistics equal the kernel route's to the bit (step_parity_f32's
    # 1e-6); the stem convolution's weight gradient on noise images sums
    # ~800k terms that cancel by ~900x. So the statistics are held at 1e-5,
    # the update of all online parameters as one vector at step_parity_f32's
    # 1e-3, each weight matrix's at 2e-2; the 1-D tensors' are reported
    # (projector.linear1.bias, ahead of a BatchNorm, has a gradient of zero
    # up to rounding).
    check(max(e for e, _ in stats_err) <= 1e-5, f"ddp BN statistics differ: {stats_err}")
    check(max(upd_err) <= 1e-3, f"ddp parameter updates differ: {upd_err}")
    check(max(e for e, _ in matrix_err) <= 2e-2, f"ddp weight updates differ: {matrix_err}")


# --- phase 7: RAFT, the correlation lookup through K2's grid-sample entry ----

RAFT_HW = (720, 1280)  # BDD100k's frames
RAFT_MICRO_BATCH = 4   # the JAX package's per-device default (live_flow_micro_batch)
RAFT_ITERS = 12


def _raft_frames(b, n, seed):
    """[b, n, 720, 1280, 3] uint8 on the card: a drifting colour grating a
    sample (`data/synthetic.py`), shifted a few pixels a frame."""
    from pixflow_tpu_torch.data.synthetic import grating_frame
    rng = np.random.default_rng(seed)
    out = np.empty((b, n, *RAFT_HW, 3), np.uint8)
    for i in range(b):
        base = grating_frame(seed * 1009 + i, 0, RAFT_HW)
        dy, dx = rng.integers(-3, 4, 2)
        for f in range(n):
            out[i, f] = np.roll(base, (f * dy, f * dx), axis=(0, 1))
    return torch.from_numpy(out).to("cuda")


def _taps_inside(grid, h, w):
    """Taps with a nonzero weight inside an [h, w] field: what a bilinear
    read at `grid` must fetch."""
    x = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    taps = 0.0
    for xc, wx in ((torch.floor(x), 1.0 - (x - torch.floor(x))),
                   (torch.floor(x) + 1.0, x - torch.floor(x))):
        for yc, wy in ((torch.floor(y), 1.0 - (y - torch.floor(y))),
                       (torch.floor(y) + 1.0, y - torch.floor(y))):
            inside = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
            taps += float((inside & (wx * wy != 0)).sum())
    return taps


def compare_raft_lookup(dev):
    """K2's grid-sample entry at RAFT-small's lookup shapes, 720 x 1280
    frames at micro-batch 4: a pyramid of 57600 images [90, 160, 1],
    [45, 80, 1], [22, 40, 1], [11, 20, 1], each read at its 7 x 7 window
    around targets a few pixels off the grid. Each level against the
    plain gather (expect 0 elements to differ), timed beside the gather and
    `F.grid_sample` on the level's NCHW view [57600, 1, h, w] (no copy);
    the bound counts the taps the read needs, as the materialising read's
    does."""
    import torch.nn.functional as F
    from pixflow_tpu_torch.models.raft.corr import build_corr_pyramid, window_grid
    from pixflow_tpu_torch.ops import resample
    from pixflow_tpu_torch.ops.kernels import grid_sample

    b, h, w = RAFT_MICRO_BATCH, RAFT_HW[0] // 8, RAFT_HW[1] // 8
    gen = torch.Generator(device=dev).manual_seed(60)
    fmap1 = torch.randn(b, h, w, 128, device=dev, generator=gen)
    fmap2 = torch.randn(b, h, w, 128, device=dev, generator=gen)
    pyramid = build_corr_pyramid(fmap1, fmap2)
    del fmap1, fmap2
    coords = resample.coords_grid(h, w, device=dev)[None] \
        + 3.0 * torch.randn(b, h, w, 2, device=dev, generator=gen)
    centroid = coords.reshape(-1, 2)
    levels = []
    for lvl, corr in enumerate(pyramid):
        n, hl, wl, c = corr.shape
        grid = window_grid(centroid, 3, lvl, hl, wl)
        before = grid_sample.launches
        got = grid_sample(corr, grid)
        launched = grid_sample.launches - before
        want = resample.grid_sample(corr, grid)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        check(differ == 0, f"raft lookup level {lvl}: {differ} elements differ from the gather")
        taps = _taps_inside(grid, hl, wl)
        bytes_ = min(taps * c * 4, corr.numel() * 4) + grid.numel() * 4 + got.numel() * 4
        ops_s = taps * c * 2 / F32_OPS_PER_S
        nchw = corr.reshape(n, 1, hl, wl)  # the same memory
        lib = lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                    align_corners=True)
        lib_err = float((lib().reshape(got.shape) - want).abs().max())
        check(lib_err <= 1e-3, f"F.grid_sample disagrees with the gather: {lib_err}")
        levels.append(dict(level=lvl, field=[n, hl, wl, c], points=[n, grid.shape[1] ** 2],
                           launches=launched, elements_differ=differ,
                           max_abs_err=float((got - want).abs().max()), taps=taps,
                           kernel_ms=cuda_ms(lambda: grid_sample(corr, grid), iters=20),
                           plain_ms=cuda_ms(lambda: resample.grid_sample(corr, grid), iters=3),
                           bound_ms=max(bytes_ / HBM_BYTES_PER_S, ops_s) * 1e3,
                           bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= ops_s
                           else "operations",
                           library_ms=cuda_ms(lib, iters=20), library_max_abs_err=lib_err))
        del got, want, grid
    del pyramid
    torch.cuda.empty_cache()
    # one lookup: the four levels
    total = {k: sum(lv[k] for lv in levels) for k in ("kernel_ms", "plain_ms", "bound_ms",
                                                      "library_ms")}
    total["max_abs_err"] = max(lv["max_abs_err"] for lv in levels)
    total["bound_by"] = "bytes" if all(lv["bound_by"] == "bytes" for lv in levels) \
        else "operations"
    emit({"phase": "kernel_raft_lookup", "frames": list(RAFT_HW), "micro_batch": b,
          "radius": 3, "levels": levels, "lookup": total, "card": nvidia_smi()})
    return total


def _raft_forward_ms(model, im1, im2):
    """(median ms of a forward between CUDA events over 5 after one
    warm-up, output of the last one, grid-entry launches of one forward)."""
    from pixflow_tpu_torch.ops.kernels import grid_sample
    with torch.no_grad():
        model(im1, im2, iters=RAFT_ITERS)
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = grid_sample.launches
            start.record()
            out = model(im1, im2, iters=RAFT_ITERS)
            end.record()
            torch.cuda.synchronize()
            launched = grid_sample.launches - before
            times.append(start.elapsed_time(end))
    return float(np.median(times)), out, launched


def raft_parity(dev):
    """One pair of 720 x 1280 frames through RAFT small and basic (seeded
    random weights, TF32 off, cuDNN deterministic): the lookup through K2's
    grid entry against the plain gather. The entry repeats the gather's op
    order, so the flows should agree to the bit; the check allows 1e-4 px."""
    from pixflow_tpu_torch.models.raft import seeded_raft
    from pixflow_tpu_torch.ops.kernels import grid_sample

    torch.backends.cudnn.deterministic = True
    frames = _raft_frames(1, 2, seed=61)
    out = {}
    for small in (True, False):
        model = seeded_raft(small, seed=62).to(dev)
        with torch.no_grad():
            before = grid_sample.launches
            low_k, up_k = model(frames[:, 0], frames[:, 1], iters=RAFT_ITERS)
            launched = grid_sample.launches - before
            low_p, up_p = model(frames[:, 0], frames[:, 1], iters=RAFT_ITERS, plain=True)
        torch.cuda.synchronize()
        name = "small" if small else "basic"
        out[name] = {"flow_low_max_abs_diff_px": float((low_k - low_p).abs().max()),
                     "flow_up_max_abs_diff_px": float((up_k - up_p).abs().max()),
                     "flow_low_elements_differ": int((low_k != low_p).sum()),
                     "flow_low_max_abs_px": float(low_k.abs().max()),
                     "grid_launches_kernel_route": launched,
                     "grid_launches_plain_route": grid_sample.launches - before - launched}
        check(launched == 4 * RAFT_ITERS and out[name]["grid_launches_plain_route"] == 0,
              f"raft {name} parity launches {out[name]}")
        check(torch.isfinite(low_k).all() and out[name]["flow_low_max_abs_diff_px"] <= 1e-4,
              f"raft {name}: kernel route vs plain {out[name]}")
        del model
    torch.backends.cudnn.deterministic = False
    emit({"phase": "raft_parity_f32", "frames": list(RAFT_HW), "iters": RAFT_ITERS,
          "tf32": False, "tolerance_px": 1e-4, **out})


def raft_run(dev):
    """RAFT small and basic at 720 x 1280, micro-batch 4, 12 iterations:
    ms a forward (median of 5 between CUDA events), directed pairs a
    second, peak memory and grid-entry launches a forward. Random weights:
    the same work as trained ones, flows without meaning."""
    from pixflow_tpu_torch.models.raft import seeded_raft

    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as a user's run
    frames = _raft_frames(RAFT_MICRO_BATCH, 2, seed=63)
    out = {}
    for small in (True, False):
        model = seeded_raft(small, seed=64).to(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ms, (low, up), launched = _raft_forward_ms(model, frames[:, 0], frames[:, 1])
        check(bool(torch.isfinite(low).all() and torch.isfinite(up).all()),
              "raft: non-finite flows")
        check(tuple(up.shape) == (RAFT_MICRO_BATCH, *RAFT_HW, 2), f"raft flow_up {up.shape}")
        check(launched == 4 * RAFT_ITERS, f"raft: {launched} grid launches a forward")
        out["small" if small else "basic"] = {
            "ms_per_forward": ms, "pairs_per_s": RAFT_MICRO_BATCH / (ms / 1e3),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "grid_launches_per_forward": launched}
        del model, low, up
    del frames
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False  # back to this script's f32 checks
    emit({"phase": "raft", "frames": list(RAFT_HW), "micro_batch": RAFT_MICRO_BATCH,
          "iters": RAFT_ITERS, "weights": "seeded random", "cudnn_tf32": True, **out,
          "card": nvidia_smi()})
    return out


LIVE_FLOW_BS = 8  # --flow_bs: the reference's per-GPU default (contrast/util.py:136)


def live_raft_run(dev, raft_path):
    """The nframe6 recipe at batch 64 with live RAFT-small (no flow files:
    10 directed pairs of 720 x 1280 frames a sample through RAFT each step,
    --flow_bs 8) on the lazy flow_up path: 1 warm-up and 2 timed steps,
    every step logged. The RAFT share is the time between CUDA events
    around the step's RAFT pass. cuDNN takes TF32 for float32 convolutions,
    PyTorch's default and a user's run's, for this phase (the script's
    float32 checks turn it off)."""
    from pixflow_tpu_torch.train import driver

    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = True
    cfg = _recipe_cfg(use_flow_file=False, flow_model=raft_path, flow_bs=LIVE_FLOW_BS)
    cfg.runtime.print_freq = 1
    b, n = cfg.data.batch_size, cfg.data.n_frames
    batch = driver.synthetic_batch(cfg, seed=65, orig_hw=RAFT_HW)
    batch = driver.to_device(batch, dev)
    raft_events = []
    make = driver.make_raft_fn

    def timed_make(*args, **kw):  # the step's RAFT pass between CUDA events
        fn, lazy = make(*args, **kw)

        def timed(frames):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(frames)
            end.record()
            raft_events.append((start, end))
            return out
        return timed, lazy

    driver.make_raft_fn = timed_make
    try:
        trainer = driver.build_trainer(cfg, dev, STEPS_PER_EPOCH)
    finally:
        driver.make_raft_fn = make
    trainer, times, launches, peak = _timed_steps(cfg, dev, [batch], 1, 2, trainer)
    torch.backends.cudnn.allow_tf32 = False
    raft_ms = [s.elapsed_time(e) for s, e in raft_events]
    logged = trainer.history
    for m in logged:
        check(math.isfinite(m["loss"]) and m["pos_num"] > 0, f"live raft step {m}")
        check(0.0 <= m["mask_ratio_fwd"] <= 1.0, f"live raft mask ratio {m}")
    steps = 3
    pairs = 2 * (n - 1)
    # one K2 grid read a pyramid level, iteration, directed pair and
    # micro-batch of 8; two flow_up_points a step and two for telemetry
    expect = {"pair_sums": 2 * steps, "pair_sums_backward": 2 * steps, "point_sample": 0,
              "flow_up_points": 4 * steps,
              "grid_sample": 4 * RAFT_ITERS * pairs * (b // LIVE_FLOW_BS) * steps}
    check(launches == expect, f"live raft launches {launches}, expected {expect}")
    del trainer, batch
    torch.cuda.empty_cache()
    step_ms = 1e3 * float(np.median(times))
    emit({"phase": "live_raft", "recipe": RECIPE, "batch": b, "flow_model": "raft-small (seeded)",
          "flow_bs": LIVE_FLOW_BS, "flow_up_lazy": True, "timed_steps": len(times),
          "cudnn_tf32": True,
          "step_ms": [1e3 * t for t in times], "step_ms_median": step_ms,
          "raft_ms": raft_ms, "raft_share": float(np.median(raft_ms[1:])) / step_ms,
          "samples_per_s": b / (step_ms / 1e3), "peak_mem_gb": peak / 1e9,
          "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
          "logged": logged, "card": nvidia_smi()})
    return launches


# --- phase 8: RAFT training, the lookup's backward kernel --------------------

CHAIRS_CROP = (368, 496)   # the chairs stage's crop (main_raft.py STAGE_CROPS)
CHAIRS_FRAME = (384, 512)  # FlyingChairs' frames
RAFT_TRAIN_BATCH = 8       # the chairs stage's batch


def _lookup_backward_case(dev, radius, crop, batch, seed):
    """(level grids, grad_outs, level shapes) of RAFT's lookup backward at
    `crop` and `batch`: feature maps crop / 8, each level's (2r+1)^2 window
    about targets a few pixels off the grid, random incoming gradients."""
    from pixflow_tpu_torch.models.raft.corr import window_grid
    from pixflow_tpu_torch.ops import resample

    h, w = crop[0] // 8, crop[1] // 8
    gen = torch.Generator(device=dev).manual_seed(seed)
    coords = resample.coords_grid(h, w, device=dev)[None] \
        + 3.0 * torch.randn(batch, h, w, 2, device=dev, generator=gen)
    centroid = coords.reshape(-1, 2)
    n, win = centroid.shape[0], 2 * radius + 1
    cases, hl, wl = [], h, w
    for lvl in range(4):
        grid = window_grid(centroid, radius, lvl, hl, wl)
        go = torch.randn(n, win, win, 1, device=dev, generator=gen)
        cases.append((f"level{lvl}", go, grid, (n, hl, wl, 1)))
        hl, wl = max(hl // 2, 1), max(wl // 2, 1)
    return cases


def compare_grid_sample_backward(dev):
    """The backward of K2's grid-sample entry (`csrc/grid_sample_bwd.cu`) at
    RAFT-basic's lookup, chairs crop 368 x 496, batch 8 (22816 rows; levels
    46 x 62, 23 x 31, 11 x 15, 5 x 7, 9 x 9 windows), and at a general grid
    (points outside, on the borders, on texel centres, 9 a row on one
    texel). Each against the plain version (`index_add_`, atomics on the
    card): |diff| <= 2^-21 x the sum of the terms' magnitudes (another
    summation order); two runs of the kernel equal to the bit. Timed beside
    the plain version and `aten.grid_sampler_2d_backward` on the NCHW views
    (grad_input only); the bound is the gradient field written once plus
    grad_out and the grid read once."""
    from pixflow_tpu_torch.ops.kernels import grid_sample_backward, grid_sample_backward_plain

    cases = _lookup_backward_case(dev, 4, CHAIRS_CROP, RAFT_TRAIN_BATCH, seed=70)
    gen = torch.Generator(device=dev).manual_seed(71)
    grid = torch.rand(64, 32, 32, 2, device=dev, generator=gen) * 2.6 - 1.3
    grid[:, 0, :, 0], grid[:, 1, :, 1], grid[:, 2] = -1.0, 1.0, 2 * 7 / 29 - 1
    grid[:, 3, :9, 0], grid[:, 3, :9, 1] = 2 * 2.25 / 29 - 1, 2 * 1.5 / 19 - 1
    grid[:, 4] = 5.0
    cases.append(("general", torch.randn(64, 32, 32, 2, device=dev, generator=gen), grid,
                  (64, 20, 30, 2)))
    out = {}
    for name, go, grid, shape in cases:
        got = grid_sample_backward(go, grid, shape)
        again = grid_sample_backward(go, grid, shape)
        want = grid_sample_backward_plain(go, grid, shape)
        mag = grid_sample_backward_plain(go.abs(), grid, shape)
        torch.cuda.synchronize()
        err = (got - want).abs()
        rel = float((err / mag.clamp_min(1e-30)).max())
        check(bool(torch.equal(got, again)), f"grid_sample_backward {name}: two runs differ")
        check(bool(torch.all(err <= 2.0 ** -21 * mag)),
              f"grid_sample_backward {name}: {rel} of the magnitude sum from the plain version")
        n, hl, wl, c = shape
        inp = torch.empty(n, c, hl, wl, device=dev)
        go_nchw = go.permute(0, 3, 1, 2)  # [N, 1, 9, 9] of RAFT's: the same memory
        lib = lambda: torch.ops.aten.grid_sampler_2d_backward(
            go_nchw, inp, grid, 0, 0, True, [True, False])[0]
        lib_err = float((lib().permute(0, 2, 3, 1) - want).abs().max())
        check(lib_err <= 1e-4 * float(mag.max()),
              f"grid_sampler_2d_backward disagrees with the plain version: {lib_err}")
        bytes_ = got.numel() * 4 + go.numel() * 4 + grid.numel() * 4
        out[name] = dict(
            grad_img=list(shape), points=[n, grid.shape[1] * grid.shape[2]],
            max_abs_err=float(err.max()), max_err_over_magnitude=rel,
            elements_differ=int((got != want).sum()),
            kernel_ms=cuda_ms(lambda: grid_sample_backward(go, grid, shape), iters=20),
            plain_ms=cuda_ms(lambda: grid_sample_backward_plain(go, grid, shape), iters=3),
            bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=cuda_ms(lib, iters=20), library_max_abs_err=lib_err)
        del got, again, want, mag
    torch.cuda.empty_cache()
    levels = [out[f"level{i}"] for i in range(4)]
    lookup = {k: sum(lv[k] for lv in levels) for k in ("kernel_ms", "plain_ms", "bound_ms",
                                                       "library_ms")}
    lookup.update(max_abs_err=max(lv["max_abs_err"] for lv in levels), bound_by="bytes")
    emit({"phase": "kernel_grid_sample_backward", "crop": list(CHAIRS_CROP),
          "batch": RAFT_TRAIN_BATCH, "radius": 4, "tolerance": "2^-21 x magnitude sum",
          **out, "lookup": lookup, "card": nvidia_smi()})
    return lookup


def _train_batch(dev, b, hw, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"img1": 255 * torch.rand(b, *hw, 3, device=dev, generator=g),
            "img2": 255 * torch.rand(b, *hw, 3, device=dev, generator=g),
            "flow": 3 * torch.randn(b, *hw, 2, device=dev, generator=g),
            "valid": (torch.rand(b, *hw, device=dev, generator=g) > 0.1).float()}


def raft_train_parity(dev):
    """One train step of RAFT small and basic (seeded weights, 128 x 192,
    batch 2, 12 iterations, TF32 off, cuDNN deterministic) through the
    kernels (the grid entry and its backward) against the same step
    through the plain gather and its autograd: the loss within 1e-6
    relative, each gradient's difference within 1e-4 of its norm (plus
    1e-8 of all gradients' norm: biases ahead of an instance norm have a
    gradient of zero up to rounding), and the updated parameters reported
    (Adam's first step is about lr x sign(g): where g is near zero its
    sign is noise)."""
    from pixflow_tpu_torch.models.raft import seeded_raft
    from pixflow_tpu_torch.ops.kernels import grid_sample, grid_sample_backward
    from pixflow_tpu_torch.train.raft_trainer import (make_raft_train_step,
                                                      raft_optimizer, raft_train_state)

    torch.backends.cudnn.deterministic = True
    batch = _train_batch(dev, 2, (128, 192), seed=72)
    out = {}
    for small in (True, False):
        runs = {}
        for plain in (False, True):
            model = seeded_raft(small, seed=73).to(dev)
            _, tx = raft_optimizer(4e-4, 1000, 1e-4)
            state = raft_train_state(model, tx)
            grads = {}
            hooks = [p.register_post_accumulate_grad_hook(
                lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
                for n, p in model.named_parameters()]
            before = (grid_sample.launches, grid_sample_backward.launches)
            _, m = make_raft_train_step(tx, iters=RAFT_ITERS, plain=plain)(state, batch)
            torch.cuda.synchronize()
            for h in hooks:
                h.remove()
            runs[plain] = (float(m["loss"]), grads, dict(model.named_parameters()),
                           (grid_sample.launches - before[0],
                            grid_sample_backward.launches - before[1]))
        (loss_k, g_k, p_k, l_k), (loss_p, g_p, p_p, l_p) = runs[False], runs[True]
        total = math.sqrt(sum(float(g.norm()) ** 2 for g in g_p.values()))
        grad_rel = {n: float((g_k[n] - g_p[n]).norm()) / max(float(g_p[n].norm()), 1e-30)
                    for n in g_p}
        grad_ok = all(float((g_k[n] - g_p[n]).norm()) <= 1e-4 * float(g_p[n].norm())
                      + 1e-8 * total for n in g_p)
        big = [n for n in g_p if float(g_p[n].norm()) > 1e-6 * total]
        param_rel = {n: float((p_k[n] - p_p[n]).detach().norm()) / float(p_p[n].detach().norm())
                     for n in p_p}
        name = "small" if small else "basic"
        out[name] = {"loss_kernels": loss_k, "loss_plain": loss_p,
                     "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
                     "grad_rel_norm_diff_max": max(grad_rel[n] for n in big),
                     "grad_rel_norm_diff_max_all": max(grad_rel.values()),
                     "grad_tensors": len(g_p),
                     "param_rel_norm_diff_max": max(param_rel.values()),
                     "param_rel_norm_diff_median": float(np.median(list(param_rel.values()))),
                     "launches_kernels": l_k, "launches_plain": l_p}
        check(l_k == (4 * RAFT_ITERS, 4 * RAFT_ITERS) and l_p == (0, 0),
              f"raft_train_parity {name} launches {l_k}, {l_p}")
        check(math.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-6 * abs(loss_p),
              f"raft_train_parity {name}: loss {loss_k} vs {loss_p}")
        check(grad_ok and float(g_k["fnet.conv1.weight"].abs().max()) > 0,
              f"raft_train_parity {name}: gradients {out[name]}")
        del runs, g_k, g_p, p_k, p_p
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    emit({"phase": "raft_train_parity_f32", "crop": [128, 192], "batch": 2,
          "iters": RAFT_ITERS, "tf32": False, **out})


def raft_train_run(dev, chairs_root):
    """RAFT-basic's chairs stage at full width: crop 368 x 496, batch 8, 12
    iterations, AdamW with the one-cycle schedule, batches assembled on the
    host from a synthetic FlyingChairs-layout corpus (augmented as
    main_raft does), cuDNN TF32 on (PyTorch's default, a user's run).
    2 warm-up and 6 timed steps, each between CUDA events: ms a step,
    pairs/s, peak memory, and the lookup's launches a step (48 forward,
    48 backward)."""
    from pixflow_tpu_torch.data.raft_datasets import fetch_stage_dataset
    from pixflow_tpu_torch.main_raft import sample_batch
    from pixflow_tpu_torch.models.raft import RAFT
    from pixflow_tpu_torch.ops.kernels import grid_sample, grid_sample_backward
    from pixflow_tpu_torch.train import to_device
    from pixflow_tpu_torch.train.raft_trainer import (make_raft_train_step,
                                                      raft_optimizer, raft_train_state)

    warm, timed, b = 2, 6, RAFT_TRAIN_BATCH
    dataset = fetch_stage_dataset("chairs", {"chairs": chairs_root}, CHAIRS_CROP)
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    batches = [to_device(sample_batch(dataset, rng, s + 1, b, seed=0), dev)
               for s in range(warm + timed)]
    host_s = time.perf_counter() - t
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = True
    model = RAFT(small=False, generator=torch.Generator().manual_seed(0)).to(dev)
    schedule, tx = raft_optimizer(4e-4, 120000, 1e-4)
    state = raft_train_state(model, tx)
    step = make_raft_train_step(tx, iters=RAFT_ITERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    grid_sample.launches = grid_sample_backward.launches = 0
    times, losses = [], []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(m["loss"]))
        if i >= warm:
            times.append(start.elapsed_time(end))
    launches = {"grid_sample": grid_sample.launches,
                "grid_sample_backward": grid_sample_backward.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    torch.backends.cudnn.allow_tf32 = False  # back to this script's f32 checks
    n = warm + timed
    check(all(math.isfinite(x) for x in losses), f"raft_train losses {losses}")
    check(launches == {"grid_sample": 4 * RAFT_ITERS * n,
                       "grid_sample_backward": 4 * RAFT_ITERS * n},
          f"raft_train launches {launches} in {n} steps")
    step_ms = float(np.median(times))
    del state, model, batches
    torch.cuda.empty_cache()
    emit({"phase": "raft_train", "model": "basic", "crop": list(CHAIRS_CROP), "batch": b,
          "iters": RAFT_ITERS, "cudnn_tf32": True, "weights": "seeded random",
          "corpus": "synthetic FlyingChairs layout", "host_batch_s": host_s / n,
          "step_ms": step_ms, "step_ms_all": times, "pairs_per_s": b / (step_ms / 1e3),
          "peak_mem_gb": peak / 1e9, "losses": losses, "launches": launches,
          "launches_per_step": {k: v / n for k, v in launches.items()},
          "lr_first_last": [schedule(0), schedule(n - 1)], "card": nvidia_smi()})
    return launches, step_ms


# --- phase 9: the CLI, training from files -----------------------------------

def run_cli(args, timeout, module="pixflow_tpu_torch.main_pretrain", env=None):
    """`python -m MODULE ARGS` in its own process group, which is killed
    whole (forked decode workers too) on timeout; returns its stdout."""
    proc = subprocess.Popen([sys.executable, "-m", module, *args],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True, env=env)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{module} {' '.join(args)}: no end in {timeout} s")
    check(proc.returncode == 0, f"{module} exited {proc.returncode}:\n{err[-4000:]}")
    return out


def read_cli_run(out_dir):
    """(metrics records, kernel launch counts of each run) from the CLI's
    metrics.jsonl and log."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(out_dir, "log.txt")) as f:
        counts = [json.loads(line.split("kernel launches: ", 1)[1])
                  for line in f if "kernel launches: " in line]
    return recs, counts


def sample_costs(dataset, n=32) -> dict:
    """Host ms per sample of each part of a loader sample, in this process,
    over the first `n` videos: the two frame decodes, the two views'
    transforms, the two flow-file reads, a whole sample, and the pickle
    round trip a process worker's sample makes."""
    import pickle
    import random

    from pixflow_tpu_torch.data.datasets import load_flow_file, load_image

    t1, t2 = dataset.transform
    parts = dict.fromkeys(("decode_2_frames", "transforms_2_views", "flows_2_files",
                           "whole_sample", "pickle_round_trip"), 0.0)
    videos = dataset.samples[:n]
    for i, video in enumerate(videos):
        name = os.path.basename(os.path.dirname(video[0][0]))
        t = time.perf_counter()
        first, last = load_image(video[0][0]), load_image(video[-1][0])
        parts["decode_2_frames"] += time.perf_counter() - t
        rng = random.Random(i)
        t = time.perf_counter()
        t1(first, rng)
        t2(last, rng)
        parts["transforms_2_views"] += time.perf_counter() - t
        t = time.perf_counter()
        for root in (dataset.flow_fwd_root, dataset.flow_bwd_root):
            load_flow_file(os.path.join(root, name + dataset.flow_ext), 0, len(video) - 1)
        parts["flows_2_files"] += time.perf_counter() - t
        t = time.perf_counter()
        sample = dataset.__getitem__(i, random.Random(i))
        parts["whole_sample"] += time.perf_counter() - t
        t = time.perf_counter()
        pickle.loads(pickle.dumps(sample))
        parts["pickle_round_trip"] += time.perf_counter() - t
    return {k: 1e3 * v / len(videos) for k, v in parts.items()}


def cli_run(recipe_step_ms, raft_path, extra_args=(), keep_checkpoint=None):
    from pixflow_tpu_torch.configs import get_recipe
    from pixflow_tpu_torch.data import build_pretrain_loader
    from pixflow_tpu_torch.data.synthetic import write_video_corpus
    from pixflow_tpu_torch.train import make_lr_schedule, scale_lr

    cores = len(os.sched_getaffinity(0))
    workers = max(cores - 2, 1)
    cfg = get_recipe(RECIPE)
    b = cfg.data.batch_size
    with tempfile.TemporaryDirectory(prefix="pixflow_cli_") as tmp:
        t0 = time.perf_counter()
        corpus_bytes = write_video_corpus(os.path.join(tmp, "bdd"), 6, frame_hw=CLI_FRAME_HW,
                                          seed=0, quality=90, n_videos=CLI_VIDEOS,
                                          workers=cores)
        corpus_s = time.perf_counter() - t0
        data_dir = os.path.join(tmp, "bdd", "images")

        # the loader alone at the recipe's settings, on the host; then with
        # the photometric ops left to the card (--device-aug: the host only
        # samples their parameters)
        cfg.data.data_dir, cfg.data.num_workers = data_dir, workers
        loader_rate = {}
        for mode in ("process", "thread", "process_device_photometric"):
            cfg.data.worker_mode = mode.split("_")[0]
            cfg.data.device_aug = mode.endswith("photometric")
            loader = build_pretrain_loader(cfg, global_batch_size=b)
            loader.start_workers()
            try:
                t = time.perf_counter()
                n = sum(len(batch["index"]) for batch in loader.epoch(1))
                loader_rate[mode] = n / (time.perf_counter() - t)
            finally:
                loader.close()
        cfg.data.device_aug = False
        steps = len(loader)
        check(steps >= 2, f"{steps} steps an epoch")
        costs = sample_costs(build_pretrain_loader(cfg, global_batch_size=b).dataset)

        out_dir = os.path.join(tmp, "out")
        args = ["--recipe", RECIPE, "--data-dir", data_dir, "--output-dir", out_dir,
                "--print-freq", "1", "--save-freq", "1", "--num-workers", str(workers),
                "--worker-mode", "process", *extra_args]
        t = time.perf_counter()
        run_cli([*args, "--debug-epochs", "2"], timeout=420)
        first_s = time.perf_counter() - t
        recs, counts = read_cli_run(out_dir)
        check(len(recs) == 2 * steps and [r["step"] for r in recs] == list(range(1, 2 * steps + 1)),
              f"first run logged steps {[r['step'] for r in recs]}, expected 1..{2 * steps}")
        for name in ("ckpt_epoch_1.pth", "ckpt_epoch_2.pth", "current.pth"):
            check(os.path.exists(os.path.join(out_dir, name)), f"no {name}")
        t = time.perf_counter()
        run_cli([*args, "--debug-epochs", "1", "--auto-resume"], timeout=420)
        resume_s = time.perf_counter() - t
        recs, counts = read_cli_run(out_dir)

        # every step logged (print_freq 1): two flow_up_points launches a
        # step, two more for the telemetry of a logged step
        expect = [{"pair_sums": 2 * n, "pair_sums_backward": 2 * n, "point_sample": 0,
                   "flow_up_points": 4 * n, "grid_sample": 0} for n in (2 * steps, steps)]
        check([r["step"] for r in recs] == list(range(1, 3 * steps + 1)),
              f"logged steps {[r['step'] for r in recs]}, expected 1..{3 * steps}")
        for r in recs:
            check(math.isfinite(r["loss"]), f"non-finite loss at step {r['step']}")
            check(r["pos_num"] > 0, f"no positive pairs at step {r['step']}")
            for key in ("mask_ratio_fwd", "mask_ratio_bwd"):
                check(0.0 <= r[key] <= 0.5, f"{key} {r[key]} at step {r['step']}")
        lr = make_lr_schedule(cfg.optim.lr_scheduler, scale_lr(cfg.optim.base_lr, b),
                              cfg.optim.epochs, cfg.optim.warmup_epoch, steps,
                              cfg.optim.warmup_multiplier, cfg.optim.lr_decay_epochs,
                              cfg.optim.lr_decay_rate)
        first_resumed = recs[2 * steps]
        check(first_resumed["epoch"] == 3 and first_resumed["lr"] == lr(2 * steps),
              f"first resumed step: {first_resumed}, schedule lr {lr(2 * steps)}")
        check(counts == expect, f"kernel launches {counts}, expected {expect}")

        if keep_checkpoint:  # the linear probe's pretrained backbone (cli_eval)
            shutil.copyfile(os.path.join(out_dir, "current.pth"), keep_checkpoint)
        epoch2 = [r["time"] for r in recs if r["epoch"] == 2]
        step_ms = 1e3 * float(np.median(epoch2))
        shutil.rmtree(out_dir)  # its checkpoints: room for the next runs
        ddp_nccl = cli_ddp_nccl(data_dir, os.path.join(tmp, "out_ddp"), workers,
                                recs[:2 * steps], step_ms, steps, extra_args)
        multispan = cli_multispan(data_dir, os.path.join(tmp, "out_multispan"), workers)
        precompute = cli_precompute(data_dir, os.path.join(tmp, "precomputed"), raft_path)
        live = cli_live_raft(data_dir, tmp, raft_path, workers)
        emit({"phase": "cli", "recipe": RECIPE, "videos": CLI_VIDEOS, "frame_hw": CLI_FRAME_HW,
              "corpus_bytes": corpus_bytes, "corpus_write_s": corpus_s,
              "cpu_count": os.cpu_count(), "affinity": cores, "workers": workers,
              "loader_samples_per_s": loader_rate, "sample_host_ms": costs,
              "steps_per_epoch": steps,
              "first_run_s": first_s, "resume_run_s": resume_s,
              "step_ms_median_epoch2": step_ms, "step_ms_epoch2": [1e3 * x for x in epoch2],
              "img_per_s": b / (step_ms / 1e3),
              "recipe_step_ms_median_synthetic": recipe_step_ms,
              "peak_mem_mb": max(r.get("peak_memory_mb", 0.0) for r in recs),
              "launches": counts, "first_resumed": first_resumed,
              "losses": [r["loss"] for r in recs], "ddp_nccl": ddp_nccl,
              "multispan": multispan,
              "precompute_flows": precompute, "live_raft": live,
              "card": nvidia_smi()})


def cli_ddp_nccl(data_dir, out_dir, workers, want, cli_step_ms, steps, extra_args=()):
    """`ddp_nccl`: the recipe's CLI as rank 0 of a world of 1 on NCCL, under
    torchrun's variables (`main_pretrain_multihost`): one epoch with a
    save, then `--auto-resume` for a second, against the `cli` phase's
    first two epochs on the same corpus and seed (`want`). Every BatchNorm
    statistic and the gradients cross NCCL's all-reduce (of one rank).
    The first steps' losses are the one-process run's to the bit; later
    ones part as cuDNN's autotuned bf16 kernels allow, so they are held at
    1e-3 and the bit-equal ones counted; the geometry's `pos_num` and the
    schedule's `lr` are exact."""
    args = ["--recipe", RECIPE, "--data-dir", data_dir, "--output-dir", out_dir,
            "--print-freq", "1", "--save-freq", "1", "--num-workers", str(workers),
            "--worker-mode", "process", "--debug-epochs", "1", *extra_args]
    runs_s = []
    for extra in ([], ["--auto-resume"]):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                   RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        t = time.perf_counter()
        run_cli([*args, *extra], timeout=420, module="pixflow_tpu_torch.main_pretrain_multihost",
                env=env)
        runs_s.append(time.perf_counter() - t)
    recs, counts = read_cli_run(out_dir)
    with open(os.path.join(out_dir, "log.txt")) as f:
        log = f.read()
    check(log.count("rank 0 of 1 (nccl)") == 2, "ddp_nccl: not a group of one on NCCL")
    check([r["step"] for r in recs] == [w["step"] for w in want] == list(range(1, 2 * steps + 1)),
          f"ddp_nccl steps {[r['step'] for r in recs]}")
    for r, w in zip(recs, want):
        check(r["lr"] == w["lr"] and r["pos_num"] == w["pos_num"],
              f"ddp_nccl step {r['step']}: lr/pos_num {r['lr']}/{r['pos_num']}, "
              f"one process {w['lr']}/{w['pos_num']}")
    # bf16 autocast, cuDNN autotuned in each process: the losses part after
    # a few steps (3.0e-5 and 7.1e-5 at most in two H100 runs); a loss is a
    # sum of cosines within [-4, 4], held at 1e-3
    loss_diff = [abs(r["loss"] - w["loss"]) for r, w in zip(recs, want)]
    check(max(loss_diff) <= 1e-3, f"ddp_nccl losses differ by {loss_diff}")
    expect = [{"pair_sums": 2 * steps, "pair_sums_backward": 2 * steps, "point_sample": 0,
               "flow_up_points": 4 * steps, "grid_sample": 0}] * 2
    check(counts == expect, f"ddp_nccl launches {counts}, expected {expect}")
    # like for like: the first epoch of a fresh process in both runs, after
    # its first step (cuDNN's search, during which the loader fills ahead);
    # the `cli` phase's epoch-2 median runs in the same process as epoch 1
    first = lambda rs: [1e3 * r["time"] for r in rs if 1 < r["step"] <= steps]
    return {"launcher": "main_pretrain_multihost, WORLD_SIZE=1", "backend": "nccl",
            "runs_s": runs_s, "losses": [r["loss"] for r in recs],
            "losses_one_process": [w["loss"] for w in want], "loss_abs_diff": loss_diff,
            "loss_bit_equal_steps": sum(r["loss"] == w["loss"] for r, w in zip(recs, want)),
            "step_ms": [1e3 * r["time"] for r in recs],
            "step_ms_one_process": [1e3 * w["time"] for w in want],
            "epoch1_step_ms_median_after_first": float(np.median(first(recs))),
            "epoch1_step_ms_median_after_first_one_process": float(np.median(first(want))),
            "cli_step_ms_median_epoch2": cli_step_ms, "launches": counts}


def cli_multispan(data_dir, out_dir, workers):
    """One epoch of the multi-span recipe through the CLI, with the
    photometric ops on the card and the exact mask ratio of every (logged)
    batch: `metrics.jsonl` holds the frame statistics and both ratios."""
    b = MULTISPAN_BATCH
    args = ["--recipe", RECIPE, "--data-dir", data_dir, "--output-dir", out_dir,
            "--print-freq", "1", "--num-workers", str(workers), "--worker-mode", "process",
            "--use_flow_frames", "--device-aug", "--mask-ratio-exact",
            "--batch-size", str(b), "--debug-epochs", "1"]
    t = time.perf_counter()
    run_cli(args, timeout=420)
    run_s = time.perf_counter() - t
    recs, counts = read_cli_run(out_dir)
    n = CLI_VIDEOS // b
    check([r["step"] for r in recs] == list(range(1, n + 1)),
          f"multi-span CLI logged steps {[r['step'] for r in recs]}, expected 1..{n}")
    for r in recs:
        check(math.isfinite(r["loss"]) and r["pos_num"] > 0, f"multi-span CLI step {r}")
        check(r["mean_n_frames"] == 6.0 and r["no_optical_flow_ratio"] == 0.0,
              f"multi-span CLI frame statistics {r}")
        for key in ("mask_ratio_fwd", "mask_ratio_bwd", "mask_ratio_exact_fwd",
                    "mask_ratio_exact_bwd"):
            check(0.0 <= r[key] <= 0.5, f"multi-span CLI {key} {r[key]} at step {r['step']}")
    # 15 windows a step; every step logged: the telemetry's 2 flow_up_points
    # and the exact ratio's materialising composition (60 reads) and masks (30)
    expect = [{"pair_sums": 30 * n, "pair_sums_backward": 30 * n, "point_sample": 0,
               "flow_up_points": 32 * n, "grid_sample": 90 * n}]
    check(counts == expect, f"multi-span CLI launches {counts}, expected {expect}")
    times = [r["time"] for r in recs[1:]]
    return {"batch": b, "steps": n, "run_s": run_s, "step_ms_median_after_first":
            1e3 * float(np.median(times)), "samples_per_s": b / float(np.median(times)),
            "peak_mem_mb": max(r.get("peak_memory_mb", 0.0) for r in recs),
            "mask_ratio": [[r["mask_ratio_fwd"], r["mask_ratio_bwd"]] for r in recs],
            "mask_ratio_exact": [[r["mask_ratio_exact_fwd"], r["mask_ratio_exact_bwd"]]
                                 for r in recs],
            "launches": counts, "losses": [r["loss"] for r in recs]}


def cli_precompute(data_dir, out_dir, raft_path):
    """`python -m pixflow_tpu_torch.precompute_flows` over every 32nd video
    of the corpus (8 of its 256 six-frame videos: 80 directed pairs), RAFT-
    small, 4 pairs a forward, .pth files as the loader reads them."""
    shard = CLI_VIDEOS // 8
    t = time.perf_counter()
    out = run_cli(["--data-dir", os.path.join(data_dir, "train"), "--out-dir", out_dir,
                   "--flow-model", raft_path, "--format", "pth", "--shard", "0", str(shard)],
                  timeout=300, module="pixflow_tpu_torch.precompute_flows")
    run_s = time.perf_counter() - t
    done = json.loads(out.strip().splitlines()[-1])
    check(done["videos"] == 8 and done["pairs"] == 80 and done["device"].startswith("cuda"),
          f"precompute_flows: {done}")
    shapes = set()
    for d in ("forward", "backward"):
        files = sorted(os.listdir(os.path.join(out_dir, d)))
        check(len(files) == 8, f"precompute_flows {d}: {files}")
        for name in files:
            flows = torch.load(os.path.join(out_dir, d, name), weights_only=True)
            check(bool(torch.isfinite(flows).all()), f"precompute_flows {d}/{name}: not finite")
            shapes.add(tuple(flows.shape))
    check(shapes == {(5, 2, CLI_FRAME_HW[0] // 8, CLI_FRAME_HW[1] // 8)},
          f"precompute_flows shapes {shapes}")
    # after the first video: cuDNN's algorithm search is behind
    steady = (done["pairs"] - 10) / (done["seconds"] - done["first_video_seconds"])
    return {"videos": done["videos"], "pairs": done["pairs"], "raft_s": done["seconds"],
            "first_video_s": done["first_video_seconds"],
            "pairs_per_s": done["pairs"] / done["seconds"],
            "pairs_per_s_after_first_video": steady, "run_s": run_s,
            "shape_pth": list(shapes.pop())}


# the nframe6 recipe's settings as flags: under --recipe, --use_flow_file
# stays on (the JAX CLI's rule), so live RAFT takes the recipe flag by flag
LIVE_RECIPE_FLAGS = ["--dataset", "bdd100k", "--aug", "BYOL", "--crop", "0.08",
                     "--image-size", "224", "--n-frames", "6", "--use_flow", "--flow_up",
                     "--alpha1", "0.01", "--alpha2", "0.5", "--arch", "resnet50",
                     "--pixpro-p", "2", "--pixpro-momentum", "0.99", "--pixpro-pos-ratio", "0.7",
                     "--pixpro-transform-layer", "1", "--pixpro-ins-loss-weight", "0",
                     "--optimizer", "lars", "--base-lr", "1.0", "--lr-scheduler", "cosine",
                     "--warmup-epoch", "5", "--warmup-multiplier", "100",
                     "--weight-decay", "1e-5", "--momentum", "0.9", "--epochs", "2000",
                     "--compute-dtype", "bfloat16"]
LIVE_CLI_BATCH = 16


def cli_live_raft(data_dir, tmp, raft_path, workers):
    """One epoch of live RAFT-small through the CLI, from JPEG frames, on
    32 of the corpus's videos (2 steps at batch 16, --flow_bs 8): the
    nframe6 recipe's settings as flags, no --recipe, no --use_flow_file."""
    from pixflow_tpu_torch import main_pretrain
    from pixflow_tpu_torch.configs import get_recipe

    b = LIVE_CLI_BATCH
    flags = [*LIVE_RECIPE_FLAGS, "--flow_model", raft_path, "--flow_bs", str(LIVE_FLOW_BS),
             "--batch-size", str(b)]
    cfg, _, _ = main_pretrain.parse_args(flags)
    want = get_recipe(RECIPE)  # the recipe, with this run's changes
    want.data.batch_size = b
    want.flow.use_flow_file, want.flow.flow_model, want.flow.flow_bs = False, raft_path, LIVE_FLOW_BS
    check(cfg.to_json() == want.to_json(), "live CLI flags differ from the recipe's settings")
    check(not cfg.flow.use_flow_file, "live CLI flags read flow files")

    sub = os.path.join(tmp, "bdd_live", "images", "train")
    os.makedirs(sub)
    for name in sorted(os.listdir(os.path.join(data_dir, "train")))[:2 * b]:
        os.symlink(os.path.join(data_dir, "train", name), os.path.join(sub, name))
    out_dir = os.path.join(tmp, "out_live_raft")
    t = time.perf_counter()
    run_cli([*flags, "--data-dir", os.path.dirname(sub), "--output-dir", out_dir,
             "--print-freq", "1", "--num-workers", str(workers), "--worker-mode", "process",
             "--debug-epochs", "1"], timeout=420)
    run_s = time.perf_counter() - t
    recs, counts = read_cli_run(out_dir)
    check([r["step"] for r in recs] == [1, 2], f"live CLI logged steps {[r['step'] for r in recs]}")
    for r in recs:
        check(math.isfinite(r["loss"]) and r["pos_num"] > 0, f"live CLI step {r}")
        check(0.0 <= r["mask_ratio_fwd"] <= 1.0, f"live CLI mask ratio {r}")
    with open(os.path.join(out_dir, "config.json")) as f:
        flow = json.load(f)["flow"]
    check(flow["use_flow"] and not flow["use_flow_file"] and flow["small"],
          f"live CLI config {flow}")
    pairs = 10
    expect = [{"pair_sums": 4, "pair_sums_backward": 4, "point_sample": 0, "flow_up_points": 8,
               "grid_sample": 4 * RAFT_ITERS * pairs * (b // LIVE_FLOW_BS) * 2}]
    check(counts == expect, f"live CLI launches {counts}, expected {expect}")
    return {"batch": b, "steps": 2, "flow_bs": LIVE_FLOW_BS, "run_s": run_s,
            "step_s": [r["time"] for r in recs],
            "peak_mem_mb": max(r.get("peak_memory_mb", 0.0) for r in recs),
            "mask_ratio": [[r["mask_ratio_fwd"], r["mask_ratio_bwd"]] for r in recs],
            "launches": counts, "losses": [r["loss"] for r in recs]}


LINEAR_CLASSES = 4
LINEAR_BATCH = 256  # main_linear's default total batch


def _d2_keys(layers=(3, 4, 6, 3)):
    """detectron2's ResNet-50 names, from its layout: the stem, conv1-3 of
    every bottleneck block, the first block's shortcut of every stage,
    each conv with its norm's four entries."""
    norm = ("weight", "bias", "running_mean", "running_var")
    convs = ["stem.conv1"]
    for s, n in enumerate(layers):
        for b in range(n):
            convs += [f"res{s + 2}.{b}.conv{i}" for i in (1, 2, 3)]
            if b == 0:
                convs.append(f"res{s + 2}.0.shortcut")
    return {f"{c}.weight" for c in convs} | {f"{c}.norm.{k}" for c in convs for k in norm}


def cli_eval(dev, chairs_root, pretrain_ckpt):
    """The training-and-evaluation CLIs on the card. `main_raft` (RAFT-basic,
    chairs stage, batch 4) for 2 steps with a save and `--validate chairs`,
    then `--resume auto` to step 4; its saved weights through
    `precompute_flows --flow-model` on one synthetic video. `main_linear` at
    ResNet-50, 224 px, batch 256 on a synthetic ImageFolder of 4 classes
    (2 steps an epoch) from the `cli` phase's pretraining checkpoint: 2
    epochs, then `-e --auto-resume`. `convert_pretrain_to_d2` on the same
    checkpoint: the full d2 key set of a ResNet-50."""
    import pickle

    from pixflow_tpu_torch.data.synthetic import write_image_folder, write_video_corpus

    with tempfile.TemporaryDirectory(prefix="pixflow_eval_") as tmp:
        out = os.path.join(tmp, "raft")
        common = ["--stage", "chairs", "--chairs-root", chairs_root, "--batch-size", "4",
                  "--print-freq", "1", "--save-freq", "2", "--output-dir", out,
                  "--validate", "chairs", "--num-workers", "4"]
        t = time.perf_counter()
        first = run_cli([*common, "--num-steps", "2"], timeout=300,
                        module="pixflow_tpu_torch.main_raft")
        second = run_cli([*common, "--num-steps", "4", "--resume", "auto"], timeout=300,
                         module="pixflow_tpu_torch.main_raft")
        raft_s = time.perf_counter() - t
        check("resumed full train state" in second and "at step 2" in second,
              f"main_raft resume:\n{second[-2000:]}")
        with open(os.path.join(out, "raft_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.join(out, "raft_val.jsonl")) as f:
            val = [json.loads(line) for line in f]
        check([r["step"] for r in recs] == [1, 2, 3, 4]
              and all(math.isfinite(r["loss"]) for r in recs), f"main_raft metrics {recs}")
        check([v["step"] for v in val] == [2, 4] and all(math.isfinite(v["epe"]) for v in val),
              f"main_raft validation {val}")
        launches = [json.loads(o.strip().splitlines()[-1].split("kernel launches: ", 1)[1])
                    for o in (first, second)]
        # 2 steps a run: 48 reads and 48 backward reads a step; each
        # validation reads 4 levels x 24 iterations a pair
        n_val = int(val[0]["n_samples"])
        check(launches == [{"grid_sample": 2 * 48 + 96 * n_val, "grid_sample_backward": 96}] * 2,
              f"main_raft launches {launches}")
        video_root = os.path.join(tmp, "bdd")
        write_video_corpus(video_root, 3, frame_hw=(256, 320), seed=1, n_videos=1)
        pre = run_cli(["--data-dir", os.path.join(video_root, "images", "train"),
                       "--out-dir", os.path.join(tmp, "flows"), "--format", "pth",
                       "--flow-model", os.path.join(out, "raft_chairs_4.pth")],
                      timeout=300, module="pixflow_tpu_torch.precompute_flows")
        done = json.loads(pre.strip().splitlines()[-1])
        check(done["videos"] == 1 and done["pairs"] == 4, f"precompute_flows: {done}")
        flows = torch.load(os.path.join(tmp, "flows", "forward", "video000.pth"),
                           weights_only=True)
        check(tuple(flows.shape) == (2, 2, 32, 40) and bool(torch.isfinite(flows).all()),
              f"precompute_flows with the trained RAFT: {tuple(flows.shape)}")

        data = os.path.join(tmp, "imagefolder")
        write_image_folder(data, LINEAR_CLASSES, 2 * LINEAR_BATCH // LINEAR_CLASSES,
                           LINEAR_BATCH // LINEAR_CLASSES, seed=2)
        lin_out = os.path.join(tmp, "linear")
        lin = ["--data-dir", data, "--pretrained-model", pretrain_ckpt, "--output-dir", lin_out,
               "--num-classes", str(LINEAR_CLASSES), "--epochs", "2", "--save-freq", "1",
               "--print-freq", "1", "--num-workers", str(max(len(os.sched_getaffinity(0)) - 2, 1)),
               "--learning-rate", "1.0"]
        t = time.perf_counter()
        run_cli(lin, timeout=400, module="pixflow_tpu_torch.main_linear")
        run_cli([*lin, "-e", "--auto-resume"], timeout=300, module="pixflow_tpu_torch.main_linear")
        linear_s = time.perf_counter() - t
        with open(os.path.join(lin_out, "linear_val.jsonl")) as f:
            lin_recs = [json.loads(line) for line in f]
        check([r["epoch"] for r in lin_recs] == [1, 2, 2] and lin_recs[2].get("eval_only"),
              f"main_linear records {lin_recs}")
        for r in lin_recs:
            check(math.isfinite(r["loss"]) and 0.0 <= r["acc1"] <= r["acc5"] <= 100.0,
                  f"main_linear metrics {r}")
        # -e evaluates the resumed epoch-2 probe: its metrics again, up to
        # another process's cuDNN algorithms (one image's decision at most)
        check(lin_recs[0]["steps"] == 2
              and abs(lin_recs[2]["acc1"] - lin_recs[1]["acc1"]) <= 100.0 / LINEAR_BATCH + 1e-6
              and abs(lin_recs[2]["loss"] - lin_recs[1]["loss"]) <= 1e-3 * abs(lin_recs[1]["loss"]),
              f"main_linear: -e after --auto-resume {lin_recs}")

        d2_path = os.path.join(tmp, "r50.pkl")
        run_cli([pretrain_ckpt, d2_path], timeout=120,
                module="pixflow_tpu_torch.convert_pretrain_to_d2")
        with open(d2_path, "rb") as f:
            d2 = pickle.load(f)
        want = _d2_keys()
        check(set(d2["model"]) == want and d2["matching_heuristics"],
              f"d2 pickle: {len(d2['model'])} keys, {len(want)} expected")
        check(all(np.isfinite(v).all() for v in d2["model"].values()), "d2 pickle: not finite")
    emit({"phase": "cli_eval",
          "main_raft": {"model": "basic", "crop": list(CHAIRS_CROP), "batch": 4,
                        "steps": [r["step"] for r in recs], "losses": [r["loss"] for r in recs],
                        "sec_per_step": [r["sec_per_step"] for r in recs],
                        "validation": val, "launches": launches, "run_s": raft_s,
                        "precompute_flows": done},
          "main_linear": {"arch": "resnet50", "image_size": 224, "batch": LINEAR_BATCH,
                          "classes": LINEAR_CLASSES, "epochs": lin_recs, "run_s": linear_s},
          "d2_keys": len(d2["model"]), "card": nvidia_smi()})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    from pixflow_tpu_torch.device import resolve_device
    from pixflow_tpu_torch.ops.kernels.build import load_library
    from pixflow_tpu_torch.train import synthetic_batch, to_device
    from pixflow_tpu_torch.configs import get_recipe

    dev = resolve_device("cuda:0")
    # f32 stays f32 (the timed RAFT phases take cuDNN's TF32 default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    t0 = time.perf_counter()
    load_library()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_count": torch.cuda.device_count(),
          "kernel_build_s": time.perf_counter() - t0})

    batch = to_device(synthetic_batch(get_recipe(RECIPE), seed=1), dev)
    k1 = compare_pair_sums(dev, batch)
    k2 = compare_point_sample(dev, batch)
    fused = compare_flow_up_points(dev, batch)
    step_parity(dev)
    launches, recipe_step_ms = recipe_run(dev)
    del batch
    torch.cuda.empty_cache()
    mat_launches = materialize_run(dev)
    multispan_parity(dev)
    multispan_run(dev)
    torch.cuda.empty_cache()
    ddp_parity(dev)
    lookup = compare_raft_lookup(dev)
    raft_parity(dev)
    raft_run(dev)
    backward = compare_grid_sample_backward(dev)
    raft_train_parity(dev)
    from pixflow_tpu_torch.data.synthetic import write_chairs_corpus
    from pixflow_tpu_torch.models.raft import seeded_raft
    with tempfile.TemporaryDirectory(prefix="pixflow_raft_") as raft_dir:
        chairs_root = os.path.join(raft_dir, "chairs")
        write_chairs_corpus(chairs_root, 40, 4, frame_hw=CHAIRS_FRAME, seed=0)
        train_launches, _ = raft_train_run(dev, chairs_root)
        raft_path = os.path.join(raft_dir, "raft-small.pth")  # 'small' in the name
        torch.save({f"module.{k}": v for k, v in seeded_raft(True, seed=66).state_dict().items()},
                   raft_path)
        live_launches = live_raft_run(dev, raft_path)
        torch.cuda.empty_cache()  # the CLI's process needs the card's memory
        pretrain_ckpt = os.path.join(raft_dir, "pretrain.pth")
        cli_run(recipe_step_ms, raft_path, keep_checkpoint=pretrain_ckpt)
        cli_eval(dev, chairs_root, pretrain_ckpt)

    def entry(name, source, replaces, launches, m):
        return {"name": name, "route": "cuda", "source": f"pixflow_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"]}

    # each kernel as its path runs it, with that path's launches: K1 and its
    # backward (dq alone: the key features are targets) on bf16 features,
    # the fused flow_up evaluation on one direction's bin centers (the
    # recipe); K2 (off that path) at up=1, tent_warp_pallas's function; K2's
    # grid-sample entry at the full-res read of the materialising path, and
    # again at RAFT's lookup (one lookup, four levels, at 720p micro-batch 4:
    # ms, bound, plain and F.grid_sample summed over its four launches;
    # launches from the live-RAFT recipe run); and that entry's backward
    # (XLA's autodiff of lookup_corr_mxu in the JAX package) at RAFT-basic's
    # chairs-stage lookup, summed over its four levels, with raft_train's
    # launches)
    kernels = [entry("pair_sums", "pair_sums", "pixflow_tpu/ops/pallas/pair_loss.py:36",
                     launches["pair_sums"], k1["bfloat16"]),
               entry("pair_sums_backward", "pair_sums_bwd",
                     "pixflow_tpu/ops/pallas/pair_loss.py:124",
                     launches["pair_sums_backward"], k1["bfloat16"]["backward_dq"]),
               entry("point_sample", "point_sample", "pixflow_tpu/ops/pallas/warp.py:50",
                     launches["point_sample"], k2["up1"]),
               entry("flow_up_points", "flow_up_points", "pixflow_tpu/ops/pallas/warp.py:50",
                     launches["flow_up_points"], fused["warp"]),
               entry("grid_sample", "point_sample", "pixflow_tpu/ops/pallas/warp.py:50",
                     mat_launches["grid_sample"], k2["grid_sample"]["flow_up"]),
               entry("grid_sample_raft_lookup", "point_sample",
                     "pixflow_tpu/ops/pallas/warp.py:50", live_launches["grid_sample"], lookup),
               entry("grid_sample_backward", "grid_sample_bwd",
                     "pixflow_tpu/models/raft/corr.py:85", train_launches["grid_sample_backward"],
                     backward)]
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
