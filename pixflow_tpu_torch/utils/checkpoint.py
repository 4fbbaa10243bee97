"""Checkpoint / auto-resume / publish: the port of
`pixflow_tpu/utils/checkpoint.py` in `torch.save` form (the reference's
own protocol, `main_pretrain.py:96-127`).

A checkpoint holds the whole `TrainState`: `model.state_dict()` (the
parameters and BatchNorm buffers of both branches), the optimizer state
(its step count and the momentum of every trainable parameter; the frozen
`_k` branch has none, its momentum is zero by construction), `step`, and
**the EMA ramp counter `ema_k`**, which the reference forgets (SURVEY.md
§5). Beside the state: the epoch, the config JSON and `extra`
(`resume_epoch`/`resume_idx` of a step-exact preemption save).

Files: `ckpt_epoch_N.pth` and a `current.pth` copy for `--auto-resume`,
both written atomically (a temporary file, then `os.replace`). Loading
restores in place onto the device the state lives on. Files are read with
`weights_only=True`: tensors, numbers and strings, no pickled code.
`publish_checkpoint` strips the training state and prefixes the filename
with the weight hash (capability of reference `publish_model.py`).

Data parallel, every rank holds the same state: rank 0 alone writes
(`save_checkpoint_rank0`, the reference's torch.save on rank 0), the others
wait at a barrier until the file is whole, and every rank reads a resume."""

from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import re
import shutil
from typing import Optional, Tuple

import torch


def _state_payload(state) -> dict:
    return {
        "step": int(state.step),
        "ema_k": int(state.ema_k),
        "model": state.model.state_dict(),
        "opt_state": {"count": int(state.opt_state.count),
                      "momentum": dict(state.opt_state.momentum)},
    }


def save_checkpoint(output_dir: str, epoch: int, state, config_json: str = "",
                    extra: Optional[dict] = None) -> str:
    os.makedirs(output_dir, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "config": config_json,
        "state": _state_payload(state),
        "extra": json.dumps(extra or {}),
    }
    path = os.path.join(output_dir, f"ckpt_epoch_{epoch}.pth")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    # current.pth must also land atomically: auto-resume prefers it, so a
    # preemption mid-copy would otherwise leave a truncated file that breaks
    # the next launch instead of falling back to the epoch files.
    cur = os.path.join(output_dir, "current.pth")
    shutil.copyfile(path, cur + ".tmp")
    os.replace(cur + ".tmp", cur)
    return path


def save_checkpoint_rank0(ctx, output_dir: str, epoch: int, state, config_json: str = "",
                          extra: Optional[dict] = None) -> Optional[str]:
    """`save_checkpoint` on rank 0 of `ctx` (a `parallel.Dist`), then a
    barrier of all ranks: the path on rank 0, None on the others."""
    path = None
    if ctx.is_main:
        path = save_checkpoint(output_dir, epoch, state, config_json, extra=extra)
    ctx.barrier()
    return path


def load_checkpoint(path: str, state) -> Tuple[object, int, dict]:
    """Restore `state` in place from a checkpoint file; returns (state,
    epoch, extra). `state` gives the structure (a freshly built TrainState)
    and the device."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    saved = payload["state"]
    momentum = saved["opt_state"]["momentum"]
    if set(momentum) != set(state.opt_state.momentum):
        raise ValueError(f"{path}: optimizer momentum covers other parameters "
                         "than this model's trainable ones")
    state.model.load_state_dict(saved["model"])
    with torch.no_grad():
        for name, buf in state.opt_state.momentum.items():
            buf.copy_(momentum[name])
    state.opt_state.count = int(saved["opt_state"]["count"])
    state.step = int(saved["step"])
    state.ema_k = int(saved["ema_k"])
    return state, int(payload["epoch"]), json.loads(payload.get("extra", "{}"))


def latest_checkpoint(output_dir: str) -> Optional[str]:
    cur = os.path.join(output_dir, "current.pth")
    if os.path.exists(cur):
        return cur
    cands = glob.glob(os.path.join(output_dir, "ckpt_epoch_*.pth"))
    if not cands:
        return None

    def epoch_of(p):
        m = re.search(r"ckpt_epoch_(\d+)", p)
        return int(m.group(1)) if m else -1

    return max(cands, key=epoch_of)


def select_branch(state_dict: dict, branch: str = "online") -> dict:
    """Pick which branch's weights downstream consumers see under the
    online names: 'online' (the reference's choice — its publisher keeps
    `encoder.`) or 'momentum' (the EMA twins `*_k`, often slightly stronger
    for evaluation in BYOL-family methods). Returns a state_dict in which
    `encoder.*`/`projector.*` hold the selected branch (the `_k` entries
    stay as they are)."""
    if branch not in ("online", "momentum"):
        raise ValueError(f"branch must be 'online' or 'momentum', not {branch!r}")
    if branch == "online":
        return dict(state_dict)
    out = dict(state_dict)
    for name, value in state_dict.items():
        top, _, rest = name.partition(".")
        if top.endswith("_k") and f"{top[:-2]}.{rest}" in out:
            out[f"{top[:-2]}.{rest}"] = value
    return out


def publish_checkpoint(ckpt_path: str, out_path: str,
                       branch: str = "online") -> str:
    """Strip optimizer/schedule state, keep only the model's parameters and
    BatchNorm buffers, and add the content hash to the filename (reference
    `publish_model.py`). `branch='momentum'` publishes the EMA encoder under
    the online names."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    published = {
        "model": select_branch(payload["state"]["model"], branch),
        "epoch": payload["epoch"],
        "config": payload.get("config", ""),
    }
    buf = io.BytesIO()
    torch.save(published, buf)
    blob = buf.getvalue()
    digest = hashlib.md5(blob).hexdigest()[:8]
    root, ext = os.path.splitext(out_path)
    final = f"{root}-{digest}{ext or '.pth'}"
    with open(final, "wb") as f:
        f.write(blob)
    return final


def load_published(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)
