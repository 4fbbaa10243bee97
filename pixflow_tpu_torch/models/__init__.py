from .convert import flax_to_torch
from .heads import MLP2d
from .norm import ViewBatchNorm
from .pixpro import (EMA_PAIRS, PixPro, ema_update, init_momentum_from_online,
                     momentum_schedule)
from .resnet import MODEL_REGISTRY, ResNet, make_resnet

__all__ = ["EMA_PAIRS", "MLP2d", "MODEL_REGISTRY", "PixPro", "ResNet",
           "ViewBatchNorm", "ema_update", "flax_to_torch",
           "init_momentum_from_online", "make_resnet", "momentum_schedule"]
