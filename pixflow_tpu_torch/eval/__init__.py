"""Evaluation: the linear probe, optical-flow validation and the detectron2
export (the port of `pixflow_tpu/eval/`)."""

from .convert_d2 import torch_resnet_to_d2
from .linear import (build_linear_state, encoder_state_dict, linear_optimizer,
                     load_pretrained_encoder, make_linear_eval_step, make_linear_train_step)

__all__ = ["build_linear_state", "encoder_state_dict", "linear_optimizer",
           "load_pretrained_encoder", "make_linear_eval_step", "make_linear_train_step",
           "torch_resnet_to_d2"]
