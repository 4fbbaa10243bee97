#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `pixflow_tpu_torch/csrc`, holds each
against its plain PyTorch version at the recipe's shapes (K1 pair sums and
their backward, with dq alone and with dq and dk, K2 point sampling, and the
fused lazy flow_up evaluation, which also times the path it replaced: the
composition through 15 K2 launches), checks one float32 train step through
the kernels against the same step through the plain versions, then trains the `pretrain_bdd100k_2000ep_nframe6` recipe at
full width (ResNet-50, 224 px, per-card batch 64, K=5 flows of 90 x 160,
bf16 autocast over f32 weights) for 2 warm-up and 10 timed steps on
synthetic data made from a seed, and checks which kernels that run launched.
Each phase prints one JSON line; then come the `kernels` line, the card's
`nvidia-smi` name and power limit, and last `{"ok": true, "device": ...}`.
Any failed check raises: no `ok` line and a non-zero exit. Without a CUDA
device it exits non-zero at once."""

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

RECIPE = "pretrain_bdd100k_2000ep_nframe6"
STEPS_PER_EPOCH = 68        # BDD100k nframe6 at global batch 1024, as bench.py
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
    emit({"phase": "kernel_point_sample", "field": [b, h, w, c], "points": [b, n],
          **results})
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
              "flow_up_points": 2 * 12 + 2 * n_tele}
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
    return launches


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
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32 throughout
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
    launches = recipe_run(dev)

    def entry(name, source, replaces, launches, m):
        return {"name": name, "route": "cuda", "source": f"pixflow_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"]}

    # each kernel as the main path runs it: K1 and its backward (dq alone:
    # the key features are targets) on bf16 features, the fused flow_up
    # evaluation on one direction's bin centers; K2 (off the path) at up=1,
    # tent_warp_pallas's function
    kernels = [entry("pair_sums", "pair_sums", "pixflow_tpu/ops/pallas/pair_loss.py:36",
                     launches["pair_sums"], k1["bfloat16"]),
               entry("pair_sums_backward", "pair_sums_bwd",
                     "pixflow_tpu/ops/pallas/pair_loss.py:124",
                     launches["pair_sums_backward"], k1["bfloat16"]["backward_dq"]),
               entry("point_sample", "point_sample", "pixflow_tpu/ops/pallas/warp.py:50",
                     launches["point_sample"], k2["up1"]),
               entry("flow_up_points", "flow_up_points", "pixflow_tpu/ops/pallas/warp.py:50",
                     launches["flow_up_points"], fused["warp"])]
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
