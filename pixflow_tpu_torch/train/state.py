"""Train state: the port of `pixflow_tpu/train/state.py`.

The JAX state is an immutable pytree; here the model (parameters + BN
statistics) and the optimizer state are updated in place, and the state
holds them with the two counters. `ema_k`, the EMA ramp counter, is part of
the state (the reference loses it on resume)."""

from __future__ import annotations

from dataclasses import dataclass

from ..models.pixpro import PixPro, init_momentum_from_online
from .lars import LarsSgd, LarsSgdState


@dataclass
class TrainState:
    step: int                   # global optimizer step (drives the LR metric)
    ema_k: int                  # EMA momentum-ramp counter
    model: PixPro               # params of both branches + BN statistics
    opt_state: LarsSgdState


def create_train_state(model: PixPro, tx: LarsSgd, ema_k0: int = 0,
                       copy_online_to_momentum: bool = True) -> TrainState:
    """Copy the online weights into the momentum branch (unless the weights
    were loaded, e.g. carried over from the JAX package) and initialize the
    optimizer state."""
    if copy_online_to_momentum:
        init_momentum_from_online(model)
    return TrainState(step=0, ema_k=ema_k0, model=model,
                      opt_state=tx.init(dict(model.named_parameters())))
