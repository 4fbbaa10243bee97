"""Precompute per-video RAFT flow files for training with --use_flow_file:
the port of `tools/precompute_flows.py`.

    python -m pixflow_tpu_torch.precompute_flows --data-dir <root>/images/train \\
        --out-dir <root>/flow/pth/train --flow-model raft-small.pth --format pth

Runs RAFT over every consecutive frame pair of every video (the videos of
`data/datasets.py:list_image_folder`), forward and backward, `--batch`
pairs a forward, and writes one file per video and direction with all its
1/8-resolution flows:

    <out>/forward/<video>.npy   [num_frames-1, h/8, w/8, 2] float32
    <out>/backward/<video>.npy  the pairs reversed (the reference's order)

`--format pth` writes torch tensors in the reference's layout
[num_frames-1, 2, h/8, w/8], which the port's loader reads as flow files.
Each file is written to a temporary name and renamed, and a video whose
two files exist is skipped, so a stopped run resumes where it stopped. It
runs on the card (`--device cpu` for tests); the correlation lookup reads
through K2's grid-sample entry there."""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("precompute RAFT flows")
    p.add_argument("--data-dir", required=True, help="root with <video>/<frames>")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--flow-model", required=True,
                   help="RAFT checkpoint; 'small' in its name selects RAFT-small")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--batch", type=int, default=4, help="frame pairs a forward")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="RAFT compute dtype; float32 only (bfloat16: ROADMAP item 9)")
    p.add_argument("--corr-dtype", choices=["follow", "float32", "bfloat16"],
                   default="follow",
                   help="correlation pyramid dtype; float32 only (bfloat16: ROADMAP item 9)")
    p.add_argument("--format", choices=["npy", "pth"], default="npy")
    p.add_argument("--shard", type=int, nargs=2, default=[0, 1], metavar=("IDX", "N"),
                   help="process every N-th video, from the IDX-th")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if a.dtype == "bfloat16" or a.corr_dtype == "bfloat16":
        raise NotImplementedError("a bfloat16 RAFT is not ported (ROADMAP.md, Queue 1 item 9): "
                                  "K2's grid-sample entry reads float32")
    return a


def _save(path: str, flows: np.ndarray, fmt: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        if fmt == "npy":
            np.save(fh, flows)
        else:
            torch.save(torch.from_numpy(flows.transpose(0, 3, 1, 2).copy()), fh)
    os.replace(tmp, path)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns, and prints as its last line of JSON, {'videos': written,
    'pairs': directed pairs computed, 'seconds': time in RAFT (frame
    decoding and file writes excluded), 'first_video_seconds': the part of
    it spent on the first video written (cuDNN's algorithm search included),
    'device': where RAFT ran}."""
    from PIL import Image

    from .data.datasets import list_image_folder
    from .device import resolve_device
    from .models.raft import load_raft

    a = parse_args(argv)
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True  # two shapes: --batch pairs and the rest
    small = "small" in os.path.basename(a.flow_model)
    model = load_raft(a.flow_model, small=small).to(dev)
    for d in ("forward", "backward"):
        os.makedirs(os.path.join(a.out_dir, d), exist_ok=True)

    videos = list_image_folder(a.data_dir, dataset="bdd100k")
    done = {"videos": 0, "pairs": 0, "seconds": 0.0, "first_video_seconds": 0.0,
            "device": str(dev)}
    for vi, video in enumerate(videos):
        if vi % a.shard[1] != a.shard[0]:
            continue
        name = os.path.basename(os.path.dirname(video[0][0]))
        out_f = os.path.join(a.out_dir, "forward", f"{name}.{a.format}")
        out_b = os.path.join(a.out_dir, "backward", f"{name}.{a.format}")
        if os.path.exists(out_f) and os.path.exists(out_b):
            continue
        # uint8 on the host; one chunk of pairs at a time goes to the device
        frames = np.stack([np.asarray(Image.open(p).convert("RGB"), np.uint8)
                           for p, _ in video])
        n = len(frames)
        fwd, bwd = [], []
        t = time.perf_counter()
        with torch.no_grad():
            for s in range(0, n - 1, a.batch):
                e = min(s + a.batch, n - 1)
                im_a = torch.from_numpy(frames[s:e]).to(dev)
                im_b = torch.from_numpy(frames[s + 1:e + 1]).to(dev)
                fwd.append(model(im_a, im_b, iters=a.iters)[0].cpu().numpy())
                bwd.append(model(im_b, im_a, iters=a.iters)[0].cpu().numpy())
        raft_s = time.perf_counter() - t  # .cpu() waited for the card
        done["seconds"] += raft_s
        if done["videos"] == 0:
            done["first_video_seconds"] = raft_s
        fwd = np.concatenate(fwd)        # [n-1, h, w, 2]
        bwd = np.concatenate(bwd)[::-1]  # the reference's order: last pair first
        _save(out_f, fwd, a.format)
        _save(out_b, np.ascontiguousarray(bwd), a.format)
        done["videos"] += 1
        done["pairs"] += 2 * (n - 1)
        print(f"[{vi}/{len(videos)}] {name}: {fwd.shape}", flush=True)
    print(json.dumps(done), flush=True)
    return done


if __name__ == "__main__":
    main()
