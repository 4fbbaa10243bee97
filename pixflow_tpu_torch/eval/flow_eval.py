"""Optical-flow validation: the port of `pixflow_tpu/eval/flow_eval.py`
(the original RAFT `evaluate.py`): full-resolution inference with
`InputPadder`, EPE and the 1/3/5 px rates for Chairs and Sintel, and for
KITTI also Fl-all (the outlier rate: EPE > 3 px and EPE / |gt| > 5%); the
Sintel and KITTI test-set submission writers.

The model is the port's RAFT on its device (the card unless it was moved);
images go to that device one pair at a time, flows come back as numpy."""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional

import numpy as np
import torch

from ..data.flow_io import write_flo, write_kitti_png
from ..data.raft_datasets import _load_image, flying_chairs, kitti, sintel
from ..models.raft.utils import InputPadder, forward_interpolate


def _device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def _pair_flow(model, img1, img2, iters: int, mode: str, flow_init=None):
    """(flow_low [h, w, 2] padded, flow_up [H, W, 2] unpadded) of one pair
    of [H, W, 3] uint8 images."""
    dev = _device(model)
    padder = InputPadder(img1.shape[:2], mode=mode)
    i1, i2 = padder.pad(torch.from_numpy(np.asarray(img1, np.float32)[None]).to(dev),
                        torch.from_numpy(np.asarray(img2, np.float32)[None]).to(dev))
    init = None if flow_init is None else torch.from_numpy(flow_init[None]).to(dev)
    low, up = model(i1, i2, iters=iters, flow_init=init)
    return low[0].cpu().numpy(), padder.unpad(up[0]).cpu().numpy()


def validate_dataset(model, dataset, iters: int = 24, mode: str = "sintel",
                     sparse: bool = False,
                     max_samples: Optional[int] = None) -> Dict[str, float]:
    """EPE metrics over a FlowDataset (no augmentor). For sparse datasets
    (KITTI-style valid masks) also Fl-all, and `epe` follows the original
    evaluate.py's KITTI convention, the mean of per-image mean EPEs, while
    the px rates and Fl-all stay pooled over pixels."""
    was_training = model.training
    model.eval()
    epes, fls, img_means = [], [], []
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    if n == 0:
        raise ValueError(
            "validation dataset is empty (wrong --*-root, or the split has "
            "no samples): refusing to report vacuous metrics")
    try:
        for i in range(n):
            img1, img2, flow_gt, valid = dataset.__getitem__(i)
            _, flow = _pair_flow(model, img1, img2, iters, mode)
            epe_map = np.sqrt(np.sum((flow - flow_gt) ** 2, axis=-1))
            v = np.asarray(valid) >= 0.5
            if sparse:
                mag = np.sqrt(np.sum(flow_gt ** 2, axis=-1))
                epe_v = epe_map[v]
                mag_v = np.maximum(mag[v], 1e-9)
                fls.append(((epe_v > 3.0) & (epe_v / mag_v > 0.05)).astype(np.float64))
                epes.append(epe_v)
                if epe_v.size:
                    img_means.append(float(epe_v.mean()))
            else:
                epes.append(epe_map[v].ravel())
    finally:
        model.train(was_training)
    all_epe = np.concatenate(epes) if epes else np.zeros(1)
    out = {
        "epe": float(np.mean(img_means) if sparse and img_means else np.mean(all_epe)),
        "1px": float(np.mean(all_epe < 1.0)),
        "3px": float(np.mean(all_epe < 3.0)),
        "5px": float(np.mean(all_epe < 5.0)),
        "n_samples": float(n),
    }
    if fls:
        out["fl_all"] = float(100.0 * np.mean(np.concatenate(fls)))
    return out


def create_sintel_submission(model, root: str, out_dir: str, iters: int = 32,
                             warm_start: bool = True) -> None:
    """MPI-Sintel test-set .flo files for upload (the original
    `evaluate.create_sintel_submission`): per scene, frames in order, each
    pair optionally warm-started from the forward splat of the previous
    pair's low-resolution flow."""
    model.eval()
    for dstype in ("clean", "final"):
        img_root = os.path.join(root, "test", dstype)
        scenes = sorted(os.listdir(img_root)) if os.path.isdir(img_root) else []
        for scene in scenes:
            frames = sorted(glob(os.path.join(img_root, scene, "*.png")))
            flow_prev = None
            for i, (f1, f2) in enumerate(zip(frames[:-1], frames[1:])):
                img1, img2 = _load_image(f1), _load_image(f2)
                low, flow = _pair_flow(model, img1, img2, iters, "sintel", flow_prev)
                if warm_start:
                    flow_prev = forward_interpolate(low)
                out_scene = os.path.join(out_dir, dstype, scene)
                os.makedirs(out_scene, exist_ok=True)
                write_flo(os.path.join(out_scene, f"frame{i + 1:04d}.flo"), flow)


def create_kitti_submission(model, root: str, out_dir: str, iters: int = 24) -> None:
    """KITTI-2015 test-set flow PNGs for upload (the original
    `evaluate.create_kitti_submission`)."""
    model.eval()
    os.makedirs(out_dir, exist_ok=True)
    img1s = sorted(glob(os.path.join(root, "testing", "image_2", "*_10.png")))
    img2s = sorted(glob(os.path.join(root, "testing", "image_2", "*_11.png")))
    for f1, f2 in zip(img1s, img2s):
        _, flow = _pair_flow(model, _load_image(f1), _load_image(f2), iters, "kitti")
        write_kitti_png(os.path.join(out_dir, os.path.basename(f1)), flow)


def validate_stage(model, stage: str, roots: dict, iters: Optional[int] = None,
                   max_samples: Optional[int] = None) -> Dict[str, float]:
    """The stage's validation split at its conventional iteration count."""
    if stage == "chairs":
        # the held-out split (chairs_split.txt, label 2), as the original
        # evaluate.validate_chairs; every pair, with a warning, without it
        ds = flying_chairs(roots["chairs"], split="validation")
        return validate_dataset(model, ds, iters or 24, mode="sintel",
                                max_samples=max_samples)
    if stage == "sintel":
        out = {}
        for dstype in ("clean", "final"):
            ds = sintel(roots["sintel"], split="training", dstype=dstype)
            m = validate_dataset(model, ds, iters or 32, mode="sintel",
                                 max_samples=max_samples)
            out.update({f"{dstype}_{k}": v for k, v in m.items()})
        return out
    if stage == "kitti":
        ds = kitti(roots["kitti"], split="training")
        return validate_dataset(model, ds, iters or 24, mode="kitti", sparse=True,
                                max_samples=max_samples)
    raise NotImplementedError(stage)
