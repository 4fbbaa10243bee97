"""Optical-flow training datasets and augmentation: the port's own copy of
`pixflow_tpu/data/raft_datasets.py` (reference `contrast/flow/datasets.py`
and `contrast/flow/utils/augmentor.py`, kept from upstream RAFT for flow
training).

Frame-pair/flow sample sources for the standard RAFT curriculum
(FlyingChairs, FlyingThings3D, Sintel, KITTI, HD1K), the staged dataset
mixes, and photometric/spatial/eraser augmentation in NumPy and PIL. The
code is the JAX package's, draw for draw: the same `random.Random` gives
the same samples in both packages."""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field
from glob import glob
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from .flow_io import read_flow_auto, read_kitti_png


def _load_image(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


@dataclass
class FlowAugmentor:
    """Photometric + spatial + eraser augmentation for dense-flow training
    (capability of reference `augmentor.py:16-136`)."""

    crop_size: Tuple[int, int]
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: bool = True
    sparse: bool = False
    eraser_prob: float = 0.5

    def _photometric(self, img1, img2, rng):
        from .transforms import ColorJitter
        jit = ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14)
        if rng.random() < 0.2:  # asymmetric jitter
            img1 = np.asarray(jit(Image.fromarray(img1), rng), np.uint8)
            img2 = np.asarray(jit(Image.fromarray(img2), rng), np.uint8)
        else:
            stack = np.concatenate([img1, img2], axis=0)
            stack = np.asarray(jit(Image.fromarray(stack), rng), np.uint8)
            img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def _eraser(self, img2, rng):
        if rng.random() < self.eraser_prob:
            h, w = img2.shape[:2]
            mean = img2.reshape(-1, 3).mean(0)
            for _ in range(rng.randint(1, 3)):
                x0 = rng.randint(0, w - 1)
                y0 = rng.randint(0, h - 1)
                dx = rng.randint(50, 100)
                dy = rng.randint(50, 100)
                img2 = img2.copy()
                img2[y0:y0 + dy, x0:x0 + dx] = mean
        return img2

    def _spatial(self, img1, img2, flow, valid, rng):
        ch, cw = self.crop_size
        h, w = img1.shape[:2]
        min_needed = max((ch + 8) / h, (cw + 8) / w)
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale = max(scale, min_needed)
        if rng.random() < 0.8:  # spatial_aug_prob
            nh, nw = int(round(h * scale)), int(round(w * scale))
            img1 = np.asarray(Image.fromarray(img1).resize((nw, nh),
                                                           Image.BILINEAR))
            img2 = np.asarray(Image.fromarray(img2).resize((nw, nh),
                                                           Image.BILINEAR))
            if not self.sparse:
                fl = Image.fromarray(flow[..., 0]).resize((nw, nh), Image.BILINEAR)
                fl2 = Image.fromarray(flow[..., 1]).resize((nw, nh), Image.BILINEAR)
                flow = np.stack([np.asarray(fl) * (nw / w),
                                 np.asarray(fl2) * (nh / h)], axis=-1)
            else:
                flow, valid = _sparse_resize(flow, valid, nw / w, nh / h)

        if self.do_flip and rng.random() < 0.5:  # h-flip
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            if valid is not None:
                valid = valid[:, ::-1]

        h, w = img1.shape[:2]
        y0 = rng.randint(0, h - ch)
        x0 = rng.randint(0, w - cw)
        sl = np.s_[y0:y0 + ch, x0:x0 + cw]
        valid_out = None if valid is None else valid[sl]
        return img1[sl], img2[sl], flow[sl], valid_out

    def __call__(self, img1, img2, flow, valid=None,
                 rng: Optional[random.Random] = None):
        rng = rng or random
        img1, img2 = self._photometric(img1, img2, rng)
        img2 = self._eraser(img2, rng)
        img1, img2, flow, valid = self._spatial(img1, img2, flow, valid, rng)
        if valid is None:
            valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow.astype(np.float32)),
                np.ascontiguousarray(valid.astype(np.float32)))


def _sparse_resize(flow, valid, fx, fy):
    """Resize a sparse (KITTI) flow field by re-scattering valid points."""
    h, w = flow.shape[:2]
    nh, nw = int(round(h * fy)), int(round(w * fx))
    ys, xs = np.nonzero(valid)
    nxs = np.clip(np.round(xs * fx).astype(int), 0, nw - 1)
    nys = np.clip(np.round(ys * fy).astype(int), 0, nh - 1)
    out = np.zeros((nh, nw, 2), np.float32)
    out_valid = np.zeros((nh, nw), bool)
    out[nys, nxs] = flow[ys, xs] * [fx, fy]
    out_valid[nys, nxs] = True
    return out, out_valid


@dataclass
class FlowDataset:
    """List of (img1, img2, flow[, valid]) samples with optional
    augmentation (capability of reference `datasets.py:18-74`)."""

    image_pairs: List[Tuple[str, str]] = field(default_factory=list)
    flow_paths: List[str] = field(default_factory=list)
    augmentor: Optional[FlowAugmentor] = None
    sparse: bool = False

    def __len__(self):
        return len(self.image_pairs)

    def __getitem__(self, index, rng: Optional[random.Random] = None):
        i1, i2 = self.image_pairs[index]
        img1, img2 = _load_image(i1), _load_image(i2)
        if self.sparse:
            flow, valid = read_kitti_png(self.flow_paths[index])
        else:
            flow, valid = read_flow_auto(self.flow_paths[index]), None
        if self.augmentor is not None:
            return self.augmentor(img1, img2, flow, valid, rng)
        if valid is None:
            valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
        return (img1, img2, flow.astype(np.float32), valid.astype(np.float32))


def sintel(root: str, split: str = "training", dstype: str = "clean",
           augmentor: Optional[FlowAugmentor] = None) -> FlowDataset:
    pairs, flows = [], []
    img_root = os.path.join(root, split, dstype)
    flow_root = os.path.join(root, split, "flow")
    for scene in sorted(os.listdir(img_root)) if os.path.isdir(img_root) else []:
        frames = sorted(glob(os.path.join(img_root, scene, "*.png")))
        for a, b in zip(frames[:-1], frames[1:]):
            pairs.append((a, b))
            flows.append(os.path.join(flow_root, scene,
                                      os.path.basename(a).replace(".png",
                                                                  ".flo")))
    return FlowDataset(pairs, flows, augmentor)


def _chairs_split_labels(root: str):
    """chairs_split.txt (the file the original RAFT repo ships; 1 = train,
    2 = validation — reference `contrast/flow/datasets.py:135-141`),
    searched next to the data, at the root's parent, and in the CWD."""
    for d in (root, os.path.dirname(os.path.abspath(root)), os.getcwd()):
        p = os.path.join(d, "chairs_split.txt")
        if os.path.isfile(p):
            return np.loadtxt(p, dtype=np.int32)
    return None


def flying_chairs(root: str, augmentor: Optional[FlowAugmentor] = None,
                  split: str = "all") -> FlowDataset:
    """split: 'all' | 'training' | 'validation'. The train/val split needs
    chairs_split.txt (see _chairs_split_labels); without it a non-'all'
    split falls back to every pair with a loud warning — validation numbers
    measured that way include trained-on pairs and are not comparable to the
    original evaluate.py."""
    images = sorted(glob(os.path.join(root, "data", "*.ppm")))
    flows = sorted(glob(os.path.join(root, "data", "*.flo")))
    pairs = [(images[2 * i], images[2 * i + 1]) for i in range(len(flows))]
    if split != "all":
        assert split in ("training", "validation"), split
        labels = _chairs_split_labels(root)
        if labels is None:
            import warnings
            warnings.warn(
                f"chairs_split.txt not found near {root!r}; using ALL "
                f"{len(flows)} FlyingChairs pairs for split={split!r} — "
                "validation will include training pairs")
        else:
            assert len(labels) >= len(flows), \
                f"chairs_split.txt has {len(labels)} rows < {len(flows)} pairs"
            want = 1 if split == "training" else 2
            keep = [i for i in range(len(flows)) if labels[i] == want]
            pairs = [pairs[i] for i in keep]
            flows = [flows[i] for i in keep]
    return FlowDataset(pairs, flows, augmentor)


def flying_things(root: str, dstype: str = "frames_cleanpass",
                  augmentor: Optional[FlowAugmentor] = None) -> FlowDataset:
    pairs, flows = [], []
    for cam in ("left",):
        for direction, off in (("into_future", 1), ("into_past", -1)):
            img_dirs = sorted(glob(os.path.join(root, dstype, "TRAIN/*/*")))
            flo_dirs = sorted(glob(os.path.join(
                root, "optical_flow/TRAIN/*/*", direction)))
            for idir, fdir in zip(img_dirs, flo_dirs):
                imgs = sorted(glob(os.path.join(idir, cam, "*.png")))
                flos = sorted(glob(os.path.join(fdir, cam, "*.pfm")))
                for i in range(len(flos) - 1):
                    if off == 1 and i + 1 < len(imgs):
                        pairs.append((imgs[i], imgs[i + 1]))
                        flows.append(flos[i])
                    elif off == -1 and i + 1 < len(imgs):
                        pairs.append((imgs[i + 1], imgs[i]))
                        flows.append(flos[i + 1])
    return FlowDataset(pairs, flows, augmentor)


def kitti(root: str, split: str = "training",
          augmentor: Optional[FlowAugmentor] = None) -> FlowDataset:
    img1 = sorted(glob(os.path.join(root, split, "image_2/*_10.png")))
    img2 = sorted(glob(os.path.join(root, split, "image_2/*_11.png")))
    flows = sorted(glob(os.path.join(root, split, "flow_occ/*_10.png")))
    return FlowDataset(list(zip(img1, img2)), flows, augmentor, sparse=True)


def hd1k(root: str, augmentor: Optional[FlowAugmentor] = None) -> FlowDataset:
    pairs, flows = [], []
    imgs = sorted(glob(os.path.join(root, "hd1k_input/image_2/*.png")))
    flos = sorted(glob(os.path.join(root, "hd1k_flow_gt/flow_occ/*.png")))
    for a, b, f in zip(imgs[:-1], imgs[1:], flos):
        pairs.append((a, b))
        flows.append(f)
    return FlowDataset(pairs, flows, augmentor, sparse=True)


def fetch_stage_dataset(stage: str, roots: dict,
                        crop_size: Tuple[int, int] = (368, 768)) -> FlowDataset:
    """The standard RAFT training curriculum mixes (capability of reference
    `datasets.py:212-255` fetch_dataloader)."""
    if stage == "chairs":
        return flying_chairs(roots["chairs"],
                             FlowAugmentor(crop_size, -0.1, 1.0),
                             split="training")
    if stage == "things":
        return flying_things(roots["things"],
                             augmentor=FlowAugmentor(crop_size, -0.4, 0.8))
    if stage == "sintel":
        return sintel(roots["sintel"], augmentor=FlowAugmentor(crop_size,
                                                               -0.2, 0.6))
    if stage == "kitti":
        return kitti(roots["kitti"],
                     augmentor=FlowAugmentor(crop_size, -0.2, 0.4,
                                             do_flip=False, sparse=True))
    raise NotImplementedError(stage)
