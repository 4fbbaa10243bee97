"""Carry weights from the JAX package's PixPro and ResNet trees into the port.

`flax_to_torch(params, batch_stats)` turns the JAX package's parameter and
batch-statistics trees (numpy or array-likes) into a state_dict with the
reference's torch names, which `PixPro.load_state_dict` takes;
`flax_resnet_to_torch` does the same for a bare ResNet of any head type
(the linear probe's, `fc`). It is the
inverse of `pixflow_tpu/models/convert_pixpro.py:torch_pixpro_to_flax`:

    conv kernels     HWIO      -> OIHW
    Dense kernels    [in, out] -> Linear weights [out, in]
    BN scale / bias            -> weight / bias
    BN mean / var              -> running_mean / running_var buffers
    encoder paths    layer2_0/shortcut/conv -> layer2.0.downsample.0
                     layer1_0/cell2/bn      -> layer1.0.bn2
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Iterator, Tuple

import numpy as np
import torch

_RESNET_BRANCHES = ("encoder", "encoder_k")


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def _resnet_names(parts: Tuple[str, ...]) -> list[str]:
    """Encoder-relative flax module path -> torch module path."""
    out: list[str] = []
    i = 0
    while i < len(parts):
        tok = parts[i]
        m = re.fullmatch(r"layer(\d)_(\d+)", tok)
        cell = re.fullmatch(r"cell(\d)", tok)
        if m:
            out += [f"layer{m.group(1)}", m.group(2)]
        elif cell and i + 1 < len(parts):
            out.append(("conv" if parts[i + 1] == "conv" else "bn") + cell.group(1))
            i += 1
        elif tok == "shortcut" and i + 1 < len(parts):
            out += ["downsample", "0" if parts[i + 1] == "conv" else "1"]
            i += 1
        else:
            out.append(tok)  # conv1 / bn1 stem, stem1.conv, stem3
        i += 1
    return out


def _torch_name(path: Tuple[str, ...], stats: bool) -> str:
    branch, mid, leaf = path[0], path[1:-1], path[-1]
    mods = _resnet_names(mid) if branch in _RESNET_BRANCHES else list(mid)
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    if leaf not in names or (stats != (leaf in ("mean", "var"))):
        raise ValueError(f"unrecognized leaf {'/'.join(path)}")
    return ".".join([branch, *mods, names[leaf]])


def flax_resnet_to_torch(params, batch_stats) -> "OrderedDict[str, torch.Tensor]":
    """A bare JAX ResNet's params + batch_stats trees (any head type: `fc`,
    `fc1`/`fc2`, `bn2` of `conv_head`) -> the port's ResNet state_dict."""
    sd = flax_to_torch({"encoder": params}, {"encoder": batch_stats})
    return OrderedDict((k.removeprefix("encoder."), v) for k, v in sd.items())


def flax_to_torch(params, batch_stats) -> "OrderedDict[str, torch.Tensor]":
    """JAX PixPro params + batch_stats trees -> the port's state_dict."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    for path, leaf in _leaves(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        sd[_torch_name(path, stats=False)] = torch.tensor(np.ascontiguousarray(arr))
    for path, leaf in _leaves(batch_stats):
        arr = np.asarray(leaf, dtype=np.float32)
        sd[_torch_name(path, stats=True)] = torch.tensor(np.ascontiguousarray(arr))
    return sd
