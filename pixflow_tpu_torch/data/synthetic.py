"""Synthetic corpora on disk, made from a seed, for tests and smoke runs
of the loaders and the CLIs. A BDD100k-shaped video corpus for
pretraining:

    <root>/images/train/videoNNN/frameNNNN.jpg
    <root>/flow/pth/train/{forward,backward}/videoNNN.pth   [K, 2, h/8, w/8] f32

(`.npy` flows are `[K, h/8, w/8, 2]`). With `--data-dir <root>/images`,
`build_pretrain_loader` finds the flows where the reference's layout puts
them (`<data-dir>/../flow/pth/train/...`).

Frames are smooth structured content (colour gratings drifting from frame
to frame), so that crops and their statistics are not those of noise.
Flows are a per-video affine motion plus noise at 1/8 of the frame size,
with the backward flows close to the reversed negated forward ones, as
`train/driver.py:synthetic_batch` makes them: the cycle mask keeps most
points.

`write_chairs_corpus` writes FlyingChairs' layout for RAFT training
(`data/raft_datasets.py:flying_chairs`): `<root>/data/NNNNN_img1.ppm`,
`NNNNN_img2.ppm`, `NNNNN_flow.flo` and `<root>/chairs_split.txt` (1 train,
2 validation). Each pair is a grating frame and its copy shifted by a
whole number of pixels, so the flow is that shift (the rolled-in border
included). `write_image_folder` writes an ImageFolder for the linear
probe (`<root>/{train,val}/classNN/imgNNNN.jpg`), each class a grating
under its own colour tint."""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import Sequence, Union

import numpy as np
import torch
from PIL import Image


def grating_frame(rng_seed: int, f: int, hw: tuple[int, int]) -> np.ndarray:
    """Frame `f` of the video seeded by `rng_seed`: two colour gratings per
    channel, drifting with f, evaluated by separable outer products."""
    rng = np.random.default_rng(rng_seed)
    h, w = hw
    y = np.arange(h, dtype=np.float32)
    x = np.arange(w, dtype=np.float32)
    img = np.full((h, w, 3), 128.0, np.float32)
    for c in range(3):
        for amp in (70.0, 35.0):
            period = rng.uniform(0.05, 0.5) * min(h, w)
            theta = rng.uniform(0, np.pi)
            drift = rng.uniform(-3, 3, 2) * f
            kx = np.float32(2 * np.pi * np.cos(theta) / period)
            ky = np.float32(2 * np.pi * np.sin(theta) / period)
            u = kx * (x + np.float32(drift[0])) + np.float32(rng.uniform(0, 2 * np.pi))
            v = ky * (y + np.float32(drift[1]))
            # sin(u + v) = sin u cos v + cos u sin v
            img[..., c] += amp * (np.outer(np.cos(v), np.sin(u)) + np.outer(np.sin(v), np.cos(u)))
    return np.clip(img, 0, 255).astype(np.uint8)


def _flows(rng_seed: int, k: int, fh: int, fw: int) -> tuple[np.ndarray, np.ndarray]:
    """(forward, backward) flows, each [k, fh, fw, 2] float32."""
    rng = np.random.default_rng(rng_seed)
    amp = np.float32(fw / 160)
    ys = np.linspace(-1, 1, fh, dtype=np.float32)[:, None]
    xs = np.linspace(-1, 1, fw, dtype=np.float32)[None, :]
    t, gx, gy = (rng.uniform(-r, r, 2).astype(np.float32) for r in (3, 1.5, 1.5))
    base = amp * np.stack([t[i] + gx[i] * xs + gy[i] * ys for i in range(2)], -1)
    fwd = base[None] + amp * 0.2 * rng.standard_normal((k, fh, fw, 2)).astype(np.float32)
    bwd = -fwd[::-1] + amp * 0.2 * rng.standard_normal(fwd.shape).astype(np.float32)
    return np.ascontiguousarray(fwd), np.ascontiguousarray(bwd)


def _write_video(args) -> int:
    root, v, n_frames, hw, seed, quality, flow_format = args
    vd = os.path.join(root, "images", "train", f"video{v:03d}")
    os.makedirs(vd, exist_ok=True)
    n_bytes = 0
    for f in range(n_frames):
        path = os.path.join(vd, f"frame{f:04d}.jpg")
        Image.fromarray(grating_frame(seed * 100003 + v, f, hw)).save(path, quality=quality)
        n_bytes += os.path.getsize(path)
    k = n_frames - 1
    if k > 0:
        fwd, bwd = _flows(seed * 100003 + v + 7, k, hw[0] // 8, hw[1] // 8)
        for name, flows in (("forward", fwd), ("backward", bwd)):
            d = os.path.join(root, "flow", "pth", "train", name)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"video{v:03d}.{flow_format}")
            if flow_format == "pth":
                torch.save(torch.from_numpy(flows.transpose(0, 3, 1, 2).copy()), path)
            else:
                np.save(path, flows)
            n_bytes += os.path.getsize(path)
    return n_bytes


def write_video_corpus(root: str, frames_per_video: Union[int, Sequence[int]],
                       frame_hw: tuple[int, int] = (720, 1280), seed: int = 0,
                       quality: int = 90, flow_format: str = "pth",
                       n_videos: int = 0, workers: int = 1) -> int:
    """Write the corpus under `root`; returns its size in bytes.
    `frames_per_video` is one count for `n_videos` videos, or a count per
    video. `workers` > 1 encodes in that many spawned processes."""
    if flow_format not in ("pth", "npy"):
        raise ValueError(f"flow_format must be 'pth' or 'npy', not {flow_format!r}")
    counts = ([frames_per_video] * n_videos if isinstance(frames_per_video, int)
              else list(frames_per_video))
    jobs = [(root, v, n, tuple(frame_hw), seed, quality, flow_format)
            for v, n in enumerate(counts)]
    if workers <= 1:
        return sum(map(_write_video, jobs))
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
        return sum(pool.map(_write_video, jobs))


def write_chairs_corpus(root: str, n_pairs: int, n_val: int = 0,
                        frame_hw: tuple[int, int] = (384, 512), seed: int = 0,
                        max_shift: int = 6) -> int:
    """FlyingChairs-layout pairs under `root` (FlyingChairs' frames are
    384 x 512); the last `n_val` are the validation split. Returns the
    corpus's size in bytes."""
    from .flow_io import write_flo

    data = os.path.join(root, "data")
    os.makedirs(data, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_bytes = 0
    for i in range(n_pairs):
        img1 = grating_frame(seed * 100003 + i, 0, frame_hw)
        dx, dy = (int(v) for v in rng.integers(-max_shift, max_shift + 1, 2))
        img2 = np.roll(img1, (dy, dx), axis=(0, 1))  # img2(p + (dx, dy)) = img1(p)
        flow = np.empty((*frame_hw, 2), np.float32)
        flow[..., 0], flow[..., 1] = dx, dy
        paths = [os.path.join(data, f"{i + 1:05d}_{k}") for k in ("img1.ppm", "img2.ppm",
                                                                  "flow.flo")]
        Image.fromarray(img1).save(paths[0])
        Image.fromarray(img2).save(paths[1])
        write_flo(paths[2], flow)
        n_bytes += sum(os.path.getsize(p) for p in paths)
    labels = np.array([1] * (n_pairs - n_val) + [2] * n_val, np.int32)
    np.savetxt(os.path.join(root, "chairs_split.txt"), labels, fmt="%d")
    return n_bytes


def write_image_folder(root: str, n_classes: int, train_per_class: int, val_per_class: int,
                       image_hw: tuple[int, int] = (256, 256), seed: int = 0,
                       quality: int = 90) -> int:
    """An ImageFolder under `root` with `train/` and `val/` splits; returns
    its size in bytes."""
    rng = np.random.default_rng(seed)
    tints = rng.uniform(0, 255, (n_classes, 3)).astype(np.float32)
    n_bytes = 0
    for split, per_class in (("train", train_per_class), ("val", val_per_class)):
        for c in range(n_classes):
            d = os.path.join(root, split, f"class{c:02d}")
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                frame = grating_frame(seed * 100003 + c * 9973 + i + (split == "val") * 5003,
                                      0, image_hw).astype(np.float32)
                img = np.clip(0.5 * frame + 0.5 * tints[c], 0, 255).astype(np.uint8)
                path = os.path.join(d, f"img{i:04d}.jpg")
                Image.fromarray(img).save(path, quality=quality)
                n_bytes += os.path.getsize(path)
    return n_bytes
