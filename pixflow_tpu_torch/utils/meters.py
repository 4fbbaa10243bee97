"""Training meters (reference `contrast/util.py:10-47`). The port's own
copy of `pixflow_tpu/utils/meters.py`, unchanged."""

from __future__ import annotations

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def topk_accuracy(logits: np.ndarray, targets: np.ndarray,
                  topk=(1,)) -> list:
    """Top-k accuracy in percent."""
    logits = np.asarray(logits)
    targets = np.asarray(targets)
    maxk = max(topk)
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = pred == targets[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]
