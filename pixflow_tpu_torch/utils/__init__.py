"""Logging, meters, metrics sinks and checkpoints: the port's counterparts
of `pixflow_tpu/utils/` (checkpoints in `torch.save` form)."""

from .logger import setup_logger
from .meters import AverageMeter, topk_accuracy
from .checkpoint import (
    save_checkpoint, load_checkpoint, latest_checkpoint, publish_checkpoint,
)

__all__ = [
    "setup_logger", "AverageMeter", "topk_accuracy",
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "publish_checkpoint",
]
