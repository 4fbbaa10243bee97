"""RAFT weights in and out of the port.

`load_raft` reads an upstream RAFT checkpoint (raft-small.pth,
raft-things.pth, ...): the port's modules carry the reference's names, so
the file loads as it is, once a `state_dict` wrapper and DataParallel's
`module.` prefix are gone (reference `main_pretrain.py:48-51`).

`raft_flax_to_torch` is the inverse of the JAX package's
`pixflow_tpu/models/raft/convert.py:torch_state_dict_to_flax`: it turns
the JAX package's RAFT variables, given as numpy, into the port's
`state_dict` (HWIO -> OIHW kernels, `scale` -> `weight`, `mean`/`var` ->
`running_*`, `layer1_0` -> `layer1.0`, `downsample_conv` ->
`downsample.0`, the strided block's norm to both of its names,
`mask_conv1/2` -> `mask.0/2`)."""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from .raft import RAFT

_RENAMES = (("downsample_conv", "downsample.0"), ("mask_conv1", "mask.0"),
            ("mask_conv2", "mask.2"))


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_path(path) -> str:
    key = ".".join(path)
    key = re.sub(r"(layer\d+)_(\d+)", r"\1.\2", key)
    for old, new in _RENAMES:
        key = key.replace(old, new)
    return key


def raft_flax_to_torch(variables: Mapping, small: bool) -> dict:
    """{'params': ..., 'batch_stats': ...} of the JAX package's
    RAFT(small=small), leaves as numpy arrays -> the port's RAFT
    `state_dict` (float32 tensors; `num_batches_tracked` 0)."""
    leaves = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            arr = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            out[f"{_torch_path(path[:-1])}.{leaves[path[-1]]}"] = torch.from_numpy(arr.copy())
    # the strided block's norm is also `downsample.1`, as the reference
    # registers it (ResidualBlock: norm3, BottleneckBlock: norm4)
    ds_norm = "norm4" if small else "norm3"
    for key in list(out):
        m = re.match(rf"(.*layer\d+\.0)\.{ds_norm}\.(.*)", key)
        if m and f"{m.group(1)}.downsample.0.weight" in out:
            out[f"{m.group(1)}.downsample.1.{m.group(2)}"] = out[key]
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return out


def load_raft(path: str, small: bool = False) -> RAFT:
    """A RAFT(small) holding the checkpoint's weights, on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    model = RAFT(small=small)
    model.load_state_dict(sd)
    return model.eval()
