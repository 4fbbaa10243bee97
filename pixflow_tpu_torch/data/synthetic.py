"""A synthetic BDD100k-shaped corpus on disk, made from a seed, for tests
and smoke runs of the loader and the CLI:

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
points."""

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
