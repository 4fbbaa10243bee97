"""Dataset listing + the two-crop video sample assembly.

Host-side counterpart of reference `contrast/data/dataset.py` redesigned for
static-shape TPU batches:

  * bdd100k mode: one item = one video directory; a random window of
    `n_frames` consecutive frames is drawn per epoch (reference
    `VideoSample.__getitem__`, `dataset.py:132-178`);
  * two-crop protocol: view1 = aug1(first frame), view2 = aug2(last frame)
    with tracked crop coordinates (`dataset.py:418-521`);
  * precomputed-flow mode: per-video flow files are sliced to the sampled
    window (fwd) and its mirrored range (bwd — `dataset.py:357-370`);
  * **static shapes**: videos shorter than `n_frames` yield fewer real flows;
    the flow stack is zero-padded to K = n_frames-1. Composing extra
    zero-flow fields is an exact identity, so the padded batch is
    mathematically identical to the reference's ragged one while keeping the
    compiled step's shapes fixed.

Flow files: `.pth` ([num_flow, 2, h, w] torch tensors, the reference's
format) or `.npy` ([num_flow, h, w, 2]) — we convert to channels-last.

The port's own copy of `pixflow_tpu/data/datasets.py`: the same listing,
window draws and crop order, so a sample is identical in both packages.
Everything here runs on the host, in loader threads or forked workers, and
never touches CUDA (`.pth` flows load with `map_location="cpu"`).
"""

from __future__ import annotations

import io
import os
import random
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from . import zipreader

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif")


def _is_image(fname: str) -> bool:
    return fname.lower().endswith(IMG_EXTENSIONS)


def list_image_folder(root: str, dataset: str = "ImageNet",
                      video_mode: Optional[bool] = None):
    """Walk root/<class>/**; returns a flat [(path, class_idx)] list, or for
    video datasets a list of videos (each a list of frame (path, idx))."""
    video_mode = dataset == "bdd100k" if video_mode is None else video_mode
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    class_to_idx = {c: i for i, c in enumerate(classes)}

    flat, videos = [], []
    for cls in classes:
        frames = []
        for dirpath, _, fnames in sorted(os.walk(os.path.join(root, cls))):
            for f in sorted(fnames):
                if _is_image(f):
                    item = (os.path.join(dirpath, f), class_to_idx[cls])
                    (frames if video_mode else flat).append(item)
        if video_mode and frames:
            videos.append(frames)
    return videos if video_mode else flat


def list_annotation_file(ann_file: str, img_prefix: str = "",
                         dataset: str = "ImageNet"):
    """Tab-separated `path<TAB>class` listing; video datasets group
    consecutive rows sharing a class id into one video."""
    flat, videos, current = [], [], []
    prev_cls = None
    with open(ann_file) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            path, cls = os.path.join(img_prefix, parts[0]), int(parts[1])
            if dataset == "bdd100k":
                if prev_cls is not None and cls != prev_cls and current:
                    videos.append(current)
                    current = []
                prev_cls = cls
                current.append((path, cls))
            else:
                flat.append((path, cls))
    if dataset == "bdd100k":
        if current:
            videos.append(current)
        return videos
    return flat


def list_coco_annotations(ann_file: str, img_prefix: str = ""):
    """COCO instances json -> flat [(path, 0)] listing (capability of
    reference `make_dataset_with_ann`'s COCO branch, `dataset.py:71-83`;
    plain json parse, no pycocotools dependency)."""
    import json as _json
    with open(ann_file) as f:
        images = _json.load(f)["images"]
    return [(os.path.join(img_prefix, im["file_name"]), 0) for im in images]


def load_image(path, decode_scale: int = 1) -> Image.Image:
    """decode_scale: JPEG DCT-domain downscale at decode time (PIL draft;
    power of 2). The crop-coordinate contract is scale-consistent — the
    10-vector's (W, H) columns describe whatever raster the transform saw,
    and the loss normalizes bin centers/diagonals and flow-sampling
    coordinates by that same size (ops/loss.py) — so scale-2 decode yields
    the same positive-pair geometry at ~4x less host decode cost, trading
    only crop pixel fidelity. Opt-in (DataConfig.decode_scale)."""
    if isinstance(path, bytes):
        img = Image.open(io.BytesIO(path))
    elif zipreader.is_zip_path(path):
        img = Image.open(io.BytesIO(zipreader.read_bytes(path)))
    else:
        img = Image.open(path)
    if decode_scale > 1:
        img.draft("RGB", (img.size[0] // decode_scale,
                          img.size[1] // decode_scale))
    return img.convert("RGB")


def load_flow_file(path: str, s_idx: int, n_idx: int):
    """Slice [s_idx:n_idx] of a per-video flow file -> ([k, h, w, 2] float32,
    total flow count)."""
    ext = os.path.splitext(path)[-1]
    if ext == ".pth":
        arr = torch.load(path, map_location="cpu", weights_only=True)
        num = int(arr.shape[0])
        out = arr[s_idx:n_idx].numpy().astype(np.float32)
        out = np.transpose(out, (0, 2, 3, 1))  # [k, 2, h, w] -> [k, h, w, 2]
    elif ext in (".npy", ".npz"):
        arr = np.load(path)
        if ext == ".npz":
            arr = arr["flow"]
        num = int(arr.shape[0])
        out = np.asarray(arr[s_idx:n_idx], np.float32)
        if out.shape[1] == 2:  # channels-first on disk
            out = np.transpose(out, (0, 2, 3, 1))
    else:
        raise NotImplementedError(f"flow file format '{ext}' not supported")
    return out, num


def mirrored_window(s_idx: int, n_idx: int, num_flow: int):
    """Backward-flow slice matching a forward window (reference
    `dataset.py:357-361`)."""
    span = n_idx - s_idx
    bwd_n = num_flow - s_idx
    return bwd_n - span, bwd_n


@dataclass
class VideoFrameDataset:
    """Two-crop (optionally multi-frame + flow) sample source."""

    samples: Sequence                      # videos or flat images
    transform: object                      # TransformCompose or (t1, t2)
    n_frames: int = 1
    two_crop: bool = True
    video_mode: bool = True
    flow_fwd_root: str = ""
    flow_bwd_root: str = ""
    flow_ext: str = ".pth"
    load_raw_frames: bool = False          # raw uint8 frames for live RAFT
    raw_frame_size: Optional[Tuple[int, int]] = None  # (H, W) resize for RAFT
    use_flow_frames: bool = False          # per-frame crop stacks (multi-span)
    flow_dtype: str = "float32"            # 'float16' halves transfer bytes
    decode_scale: int = 1                  # JPEG draft decode (1/2/4/8)
    # native ROI decode: crops decode only their own band via libjpeg
    # (data/jpegroi.py); non-JPEG files fall back to PIL
    native_decode: bool = False
    # with native_decode + a byte cache: losslessly re-wrap cached JPEGs
    # with per-MCU-row restart markers at init_cache time so crop decodes
    # splice out just the needed rows (skipping the entropy decode of
    # everything above the band — the measured host floor, docs/PERF.md).
    # On-disk corpora are transcoded once with tools/transcode_restart.py
    # instead (the decoder auto-detects restart-aligned streams).
    restart_transcode: bool = False

    def __post_init__(self):
        self.use_flow_file = bool(self.flow_fwd_root) and bool(self.flow_bwd_root)
        # flowpack mode: roots are .fpk shard files, or directories of
        # shard-*.fpk (per-host sharded corpora) — native mmap reader
        def _is_pack(root):
            if root.endswith(".fpk"):
                return True
            import glob as _glob
            return bool(os.path.isdir(root)
                        and _glob.glob(os.path.join(root, "*.fpk")))
        self._pack_mode = self.use_flow_file and _is_pack(self.flow_fwd_root)
        self._pack_pair = None

    def _packs(self):
        # one assignment publishes both readers, so a loader thread never
        # finds the forward reader open and the backward one not yet (the
        # JAX package's two assignments let it); threads that race here may
        # each open a pair, and the spare pair closes when collected
        if self._pack_pair is None:
            from .flowpack import open_flow_source
            self._pack_pair = (open_flow_source(self.flow_fwd_root),
                               open_flow_source(self.flow_bwd_root))
        return self._pack_pair

    def init_cache(self, mode: str = "part", host_id: int = 0,
                   num_hosts: int = 1):
        """In-memory byte cache of the encoded images (reference
        `DatasetFolder.init_cache`, `dataset.py:242-261`): 'full' caches
        everything, 'part' only this host's stride of the sample index."""
        if mode == "no":
            return
        assert mode in ("part", "full")
        self._byte_cache = {}
        for i, item in enumerate(self.samples):
            if mode == "part" and i % num_hosts != host_id:
                continue
            frames = item if self.video_mode else [item]
            for path, _ in frames:
                if isinstance(path, str) and not zipreader.is_zip_path(path):
                    with open(path, "rb") as f:
                        self._byte_cache[path] = f.read()
                elif isinstance(path, str):
                    self._byte_cache[path] = zipreader.read_bytes(path)
        if self.restart_transcode and self.native_decode:
            from .jpegroi import restart_rows, transcode_restart
            for path, data in self._byte_cache.items():
                if (path.lower().endswith((".jpg", ".jpeg"))
                        and restart_rows(data) == 0):
                    try:
                        self._byte_cache[path] = transcode_restart(data)
                    except ValueError:
                        pass  # damaged/exotic stream: keep the original

    def _load(self, path):
        cache = getattr(self, "_byte_cache", None)
        data = cache.get(path) if cache is not None else None
        if (self.native_decode and isinstance(path, str)
                and path.lower().endswith((".jpg", ".jpeg"))):
            from .jpegroi import JpegSource
            if data is None:
                if zipreader.is_zip_path(path):
                    data = zipreader.read_bytes(path)
                else:
                    with open(path, "rb") as f:
                        data = f.read()
            return JpegSource(data)
        if data is not None:
            return load_image(data, self.decode_scale)
        return load_image(path, self.decode_scale)

    def __len__(self):
        return len(self.samples)

    @property
    def n_flows(self) -> int:
        return max(self.n_frames - 1, 0)

    def _frame_window(self, video, rng: random.Random):
        n_video = len(video)
        eff = min(self.n_frames, n_video)
        start = rng.randint(0, n_video - eff)
        return [video[start + i] for i in range(eff)], start, eff

    def _transforms(self):
        if isinstance(self.transform, tuple):
            return self.transform
        return self.transform, self.transform

    def __getitem__(self, index: int, rng: Optional[random.Random] = None):
        rng = rng or random
        if self.video_mode:
            video = self.samples[index]
            frames, start, eff = self._frame_window(video, rng)
        else:
            frames, start, eff = [self.samples[index]], 0, 1

        # the standard two-crop path only crops the window's FIRST and LAST
        # frames — don't pay JPEG decode for the interior ones (3x fewer
        # decodes at n_frames=6). Multi-span and live-RAFT need every frame.
        need_all = self.load_raw_frames or (
            self.use_flow_frames and self.two_crop and self.n_frames > 2)
        if need_all or len(frames) <= 2:
            imgs = [self._load(p) for p, _ in frames]
        else:
            first = self._load(frames[0][0])
            last = self._load(frames[-1][0])
            imgs = [first] + [None] * (len(frames) - 2) + [last]
        target = frames[0][1]
        t1, t2 = self._transforms()

        out1 = t1(imgs[0], rng)
        im1, coord1 = out1[0], out1[1]
        sample = {
            "im1": im1,
            "coord1": coord1,
            "index": np.int32(index),
            "target": np.int32(target),
            "n_frames_eff": np.int32(eff),
        }
        if len(out1) == 3:  # device-photometric mode: per-crop aug params
            sample["aug1"] = out1[2]
        if self.two_crop:
            out2 = t2(imgs[-1], rng)
            sample["im2"] = out2[0]
            sample["coord2"] = out2[1]
            if len(out2) == 3:
                sample["aug2"] = out2[2]

        if self.use_flow_frames and self.two_crop and self.n_frames > 2:
            # per-frame crop stacks for multi-span training: view-1 crops of
            # frames 0..F-1, view-2 crops of frames 1..F (the reference's
            # img_list/img2_list protocol, `dataset.py:451-483`), padded to
            # static F = n_frames-1 by repeating the last real crop.
            f_static = self.n_frames - 1
            v1 = [t1(img, rng) for img in imgs[:-1]]
            v2 = [t2(img, rng) for img in imgs[1:]]
            while len(v1) < f_static:
                v1.append(v1[-1])
                v2.append(v2[-1])
            sample["ims1"] = np.stack([o[0] for o in v1])
            sample["coords1"] = np.stack([o[1] for o in v1])
            sample["ims2"] = np.stack([o[0] for o in v2])
            sample["coords2"] = np.stack([o[1] for o in v2])
            if len(v1[0]) == 3:  # device-photometric: per-frame aug params
                sample["augs1"] = np.stack([o[2] for o in v1])
                sample["augs2"] = np.stack([o[2] for o in v2])

        if self.use_flow_file and self.two_crop and self.n_flows > 0:
            video_name = os.path.basename(os.path.dirname(frames[0][0]))
            k_eff = eff - 1
            if self._pack_mode:
                pf, pb = self._packs()
                num_flow = pf.num_flows(pf.find(video_name))
                fwd = pf.read(video_name, start, k_eff)
                bs, bn = mirrored_window(start, start + k_eff, num_flow)
                bwd = pb.read(video_name, bs, bn - bs)
            else:
                fwd_path = os.path.join(self.flow_fwd_root,
                                        video_name + self.flow_ext)
                bwd_path = os.path.join(self.flow_bwd_root,
                                        video_name + self.flow_ext)
                fwd, num_flow = load_flow_file(fwd_path, start, start + k_eff)
                bs, bn = mirrored_window(start, start + k_eff, num_flow)
                bwd, _ = load_flow_file(bwd_path, bs, bn)
            out_dt = np.float16 if self.flow_dtype == "float16" else np.float32
            # copy=False: the pack reader already yields the transfer dtype,
            # so this is a no-op there (the astype copy was ~10% of the
            # whole per-sample host budget)
            sample["flows_fwd"] = _pad_flows(fwd, self.n_flows).astype(
                out_dt, copy=False)
            sample["flows_bwd"] = _pad_flows(bwd, self.n_flows).astype(
                out_dt, copy=False)

        if self.load_raw_frames:
            raws = []
            for img in imgs:
                if hasattr(img, "to_pil"):
                    img = img.to_pil()
                if self.raw_frame_size is not None:
                    h, w = self.raw_frame_size
                    img = img.resize((w, h), Image.BILINEAR)
                raws.append(np.asarray(img, np.uint8))
            while len(raws) < self.n_frames:  # static shape: repeat last
                raws.append(raws[-1])
            sample["frames"] = np.stack(raws)

        return sample


def _pad_flows(flows: np.ndarray, k: int) -> np.ndarray:
    """Zero-pad the flow stack to K entries (identity under composition).
    Padding follows the input dtype so an f16 pack read stays f16 end-to-end
    (concatenate with f32 would silently promote and re-copy)."""
    if flows.shape[0] == k:
        return flows
    pad = np.zeros((k - flows.shape[0],) + flows.shape[1:], flows.dtype)
    return np.concatenate([flows, pad], axis=0)


def frame_stats(n_frames_eff: np.ndarray, max_frames: int):
    """Per-batch frame-count telemetry. The reference *calls*
    `util.calc_frame_ratio` but never defines it (`main_pretrain.py:230`,
    SURVEY.md §4.6); this is our definition: returns
    (mean_frames, no_flow_ratio, per_count [max_frames, 2] = (fraction, count))."""
    n = np.asarray(n_frames_eff)
    mean_frames = float(n.mean()) if n.size else 0.0
    no_flow_ratio = float((n <= 1).mean()) if n.size else 0.0
    per_count = np.zeros((max_frames, 2), np.float32)
    for i in range(1, max_frames + 1):
        cnt = int((n == i).sum())
        per_count[i - 1] = (cnt / max(n.size, 1), cnt)
    return mean_frames, no_flow_ratio, per_count
