"""RAFT inference utilities: the port of `pixflow_tpu/models/raft/utils.py`
(the reference's `contrast/flow/utils/utils.py`): padding to multiples of
8 and the forward-interpolation warm start."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class InputPadder:
    """Pads [B, H, W, C] images so that H and W are multiples of 8, with
    edge replication (the reference's F.pad(mode='replicate')). Mode
    'sintel' pads both sides evenly; otherwise W evenly and H at the
    bottom."""

    def __init__(self, dims, mode: str = "sintel"):
        self.ht, self.wd = dims[-3:-1] if len(dims) == 4 else dims[-2:]
        pad_ht = (((self.ht // 8) + 1) * 8 - self.ht) % 8
        pad_wd = (((self.wd // 8) + 1) * 8 - self.wd) % 8
        if mode == "sintel":
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2)
        else:
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)

    def pad(self, *images: torch.Tensor):
        # replicate padding pads the last two axes of an NCHW tensor
        return [F.pad(x.permute(0, 3, 1, 2).float(), self._pad, mode="replicate")
                .permute(0, 2, 3, 1).to(x.dtype) for x in images]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        ht, wd = x.shape[-3:-1]
        return x[..., t:ht - b, l:wd - r, :]


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Forward-splat a flow field [H, W, 2] onto the regular grid by
    nearest-neighbour scattering of the advected points (the warm start
    between video frames, reference `utils.py:29-61`)."""
    from scipy import interpolate

    flow = np.asarray(flow)
    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf, dyf = dx.reshape(-1), dy.reshape(-1)

    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dxf, dyf = x1[valid], y1[valid], dxf[valid], dyf[valid]

    fx = interpolate.griddata((x1, y1), dxf, (x0, y0), method="nearest", fill_value=0)
    fy = interpolate.griddata((x1, y1), dyf, (x0, y0), method="nearest", fill_value=0)
    return np.stack([fx, fy], axis=-1).astype(np.float32)
