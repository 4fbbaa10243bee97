from .driver import (Trainer, build_model, build_optimizer, build_trainer,
                     check_ported, run_steps, synthetic_batch, to_device, train)
from .lars import LarsSgd, LarsSgdState, frozen_momentum_branch_names, lars_sgd, sgd
from .schedule import make_lr_schedule, scale_lr, warmup_cosine, warmup_multistep
from .state import TrainState, create_train_state
from .train_step import make_train_step, prep_images

__all__ = ["LarsSgd", "LarsSgdState", "TrainState", "Trainer", "build_model",
           "build_optimizer", "build_trainer", "check_ported", "create_train_state",
           "frozen_momentum_branch_names", "lars_sgd", "make_lr_schedule",
           "make_train_step", "prep_images", "run_steps", "scale_lr", "sgd",
           "synthetic_batch", "to_device", "train", "warmup_cosine", "warmup_multistep"]
