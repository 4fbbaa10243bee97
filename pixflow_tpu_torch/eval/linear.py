"""Linear evaluation: the frozen-backbone probe, the port of
`pixflow_tpu/eval/linear.py` (reference `main_linear.py`).

A ResNet with the `reduce` head (one `fc`) is built, the pretrained
encoder's weights and BatchNorm statistics are grafted onto its trunk (the
checkpoint's `encoder.*` entries map one to one), and only `fc` trains,
with momentum SGD and cross entropy. The backbone's parameters take no
gradient, no weight decay and no momentum, but its BatchNorm runs in
training mode over the batch and updates its running statistics, like the
reference's never-eval'd backbone; the eval step normalises with the
running statistics.

Data parallel (`group`): the backbone's BatchNorms average their
statistics over the ranks and the fc gradients are averaged over them
before SGD (the cross entropy is a per-sample mean), so N ranks take the
step one process takes on the global batch."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import make_resnet
from ..parallel.multihost import all_reduce_sum_
from ..models.resnet import ResNet
from ..train.lars import LarsSgd, sgd
from ..train.state import TrainState
from ..utils.checkpoint import select_branch

PROBE = "fc."


def frozen_backbone_names(model: ResNet) -> set[str]:
    """Every parameter name but the fc probe's."""
    return {n for n, _ in model.named_parameters() if not n.startswith(PROBE)}


def linear_optimizer(lr_schedule, momentum: float = 0.9, weight_decay: float = 0.0,
                     model: Optional[ResNet] = None) -> LarsSgd:
    """SGD over the fc head only (reference `main_linear.py:32-39`)."""
    frozen = frozen_backbone_names(model) if model is not None else None
    return sgd(lr_schedule, momentum=momentum, weight_decay=weight_decay, frozen=frozen)


def build_linear_state(arch: str, num_classes: int, lr_schedule, momentum: float = 0.9,
                       weight_decay: float = 0.0, seed: int = 0, device=None, group=None):
    """(optimizer, TrainState): a seeded ResNet with the `reduce` head on
    `device` (its BatchNorms over `group`'s ranks when given), its
    backbone's parameters frozen (requires_grad off: the step computes
    fc's gradient alone), and `linear_optimizer` over it with its state."""
    model = make_resnet(arch, head_type="reduce", low_dim=num_classes,
                        generator=torch.Generator().manual_seed(seed), group=group)
    model = model.to(device, memory_format=torch.channels_last)
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith(PROBE))
    tx = linear_optimizer(lr_schedule, momentum, weight_decay, model)
    return tx, TrainState(step=0, ema_k=0, model=model,
                          opt_state=tx.init(dict(model.named_parameters())))


def encoder_state_dict(checkpoint: dict, branch: str = "online") -> dict:
    """The encoder's entries, without the `encoder.` prefix, of a pretraining
    checkpoint (`ckpt_epoch_N.pth`, `current.pth`) or a published one
    (`publish_checkpoint`), from the online or the momentum branch."""
    sd = checkpoint["state"]["model"] if "state" in checkpoint else checkpoint["model"]
    sd = select_branch(sd, branch)
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    return enc or dict(sd)


@torch.no_grad()
def load_pretrained_encoder(state: TrainState, encoder_sd: dict) -> TrainState:
    """Graft the encoder's weights and BatchNorm statistics onto the probe's
    trunk: every entry the probe has, except `fc`."""
    own = state.model.state_dict()
    for k, v in encoder_sd.items():
        if k in own and not k.startswith(PROBE):
            own[k].copy_(v)
    return state


def make_linear_train_step(tx: LarsSgd, lr_schedule, autocast_dtype=None, group=None):
    """One probe step on TrainState (updated in place): BN in training mode
    (its statistics move), cross entropy, SGD on fc (its gradients averaged
    over `group`'s ranks when given). batch: image [B, H, W, 3] float,
    label [B] int64. Metrics: this rank's loss and acc1, and lr, the
    schedule at the step's count, as 0-d tensors or floats."""

    def step(state: TrainState, batch: dict):
        model = state.model
        model.train()
        params = dict(model.named_parameters())
        with torch.autocast(batch["image"].device.type, dtype=autocast_dtype or torch.bfloat16,
                            enabled=autocast_dtype is not None):
            logits = model(batch["image"]).float()
        loss = F.cross_entropy(logits, batch["label"])
        names = [n for n in params if n not in tx.frozen]
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        if group is not None:
            all_reduce_sum_(grads, group)
            torch._foreach_div_(list(grads), dist.get_world_size(group))
        tx.step_(state.opt_state, params, dict(zip(names, grads)))
        acc1 = (logits.argmax(-1) == batch["label"]).float().mean() * 100.0
        metrics = {"loss": loss.detach(), "acc1": acc1, "lr": lr_schedule(state.step)}
        state.step += 1
        return state, metrics

    return step


def make_linear_eval_step(autocast_dtype=None):
    """(state, batch) -> loss, acc1, acc5 of the batch, BN on its running
    statistics."""

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: dict):
        model = state.model
        model.eval()
        with torch.autocast(batch["image"].device.type, dtype=autocast_dtype or torch.bfloat16,
                            enabled=autocast_dtype is not None):
            logits = model(batch["image"]).float()
        label = batch["label"]
        loss = F.cross_entropy(logits, label)
        top1 = (logits.argmax(-1) == label).float().mean() * 100.0
        k5 = min(5, logits.shape[-1])
        top5 = (logits.topk(k5, dim=-1).indices == label[:, None]).any(-1).float().mean() * 100.0
        return {"loss": loss, "acc1": top1, "acc5": top5}

    return eval_fn
