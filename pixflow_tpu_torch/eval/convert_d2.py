"""Export a pretrained backbone to detectron2's ResNet layout: the port of
`pixflow_tpu/eval/convert_d2.py` (reference
`transfer/detection/convert_pretrain_to_d2.py`), for the CityScapes, COCO
and VOC transfer evaluations.

The source is the port's ResNet state_dict (the reference's torch names:
`conv1`, `bn1`, `layer1.0.conv2`, `layer2.0.downsample.0`); the result
renames it to d2's scheme (`stem.conv1`, `res2..res5`, each BatchNorm as
`<conv>.norm`, the projection as `shortcut`) and pickles it in the form
d2's checkpointer accepts: {"model": {name: numpy array}, "__author__",
"matching_heuristics": True}. Kernels are OIHW, as d2 stores them."""

from __future__ import annotations

import pickle
import re
from typing import Dict, Optional

import numpy as np

_BN = ("weight", "bias", "running_mean", "running_var")


def _np(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().float().numpy())


def torch_resnet_to_d2(state_dict: dict, out_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """state_dict: a ResNet trunk's (e.g. a pretraining checkpoint's
    `encoder.*` entries, prefix removed). Returns the d2 weight dict; writes
    the pickle when out_path is given."""
    out: Dict[str, np.ndarray] = {}

    def put_bn(d2_prefix: str, src: str):
        for k in _BN:
            out[f"{d2_prefix}.norm.{k}"] = _np(state_dict[f"{src}.{k}"])

    out["stem.conv1.weight"] = _np(state_dict["conv1.weight"])
    put_bn("stem.conv1", "bn1")
    blocks = sorted({(int(m.group(1)), int(m.group(2)))
                     for m in (re.match(r"layer(\d)\.(\d+)\.", k) for k in state_dict) if m})
    for stage, b in blocks:
        src, d2p = f"layer{stage}.{b}", f"res{stage + 1}.{b}"
        cell = 1
        while f"{src}.conv{cell}.weight" in state_dict:
            out[f"{d2p}.conv{cell}.weight"] = _np(state_dict[f"{src}.conv{cell}.weight"])
            put_bn(f"{d2p}.conv{cell}", f"{src}.bn{cell}")
            cell += 1
        if f"{src}.downsample.0.weight" in state_dict:
            out[f"{d2p}.shortcut.weight"] = _np(state_dict[f"{src}.downsample.0.weight"])
            put_bn(f"{d2p}.shortcut", f"{src}.downsample.1")

    if out_path:
        payload = {"model": out, "__author__": "pixflow-tpu", "matching_heuristics": True}
        with open(out_path, "wb") as fh:
            pickle.dump(payload, fh)
    return out
