"""Linear-evaluation CLI of the PyTorch/CUDA port (the JAX package's
`main_linear.py`, the reference's flag surface):

    python -m pixflow_tpu_torch.main_linear --data-dir IMAGENET \\
        --pretrained-model OUT/current.pth --output-dir OUT/linear

`--data-dir` holds `train/<class>/...` and `val/<class>/...` images.
`--pretrained-model` is a pretraining checkpoint of the port
(`ckpt_epoch_N.pth`, `current.pth`) or a published one. One addition:
`--device` (default `cuda`; `--device cpu` runs on the CPU); a missing
card is an error.

Data parallel, one process a card: `torchrun --nproc_per_node N -m
pixflow_tpu_torch.main_linear ...`; `--total-batch-size` is the global
batch and `--mesh-shape`, when given, must equal N. The validation metrics
are global on every rank."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .configs import LinearConfig


def parse_args(argv: Optional[Sequence[str]] = None):
    """(LinearConfig, pretrained model path, branch, device)."""
    p = argparse.ArgumentParser("pixflow-tpu linear stage (PyTorch/CUDA port)")
    p.add_argument("--data-dir", type=str, default="./data")
    p.add_argument("--dataset", type=str, default="ImageNet", choices=["ImageNet", "bdd100k"])
    p.add_argument("--crop", type=float, default=0.08)
    p.add_argument("--aug", type=str, default="NULL")
    p.add_argument("--image-size", nargs="+", type=int, default=[224])
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--total-batch-size", type=int, default=256)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--arch", type=str, default="resnet50")
    p.add_argument("--learning-rate", type=float, default=30.0)
    p.add_argument("--lr-scheduler", type=str, default="cosine")
    p.add_argument("--warmup-epoch", type=int, default=0)
    p.add_argument("--warmup-multiplier", type=float, default=100)
    p.add_argument("--lr-decay-epochs", type=int, nargs="+", default=[120, 160, 200])
    p.add_argument("--lr-decay-rate", type=float, default=0.1)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--start-epoch", type=int, default=1)
    p.add_argument("--pretrained-model", type=str, required=True)
    p.add_argument("--pretrained-branch", choices=["online", "momentum"], default="online",
                   help="probe the online or the EMA (momentum) encoder")
    p.add_argument("-e", "--eval", action="store_true")
    p.add_argument("--output-dir", type=str, default="./output")
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--print-freq", type=int, default=100)
    p.add_argument("--save-freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", type=str, default="float32")
    p.add_argument("--mesh-shape", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    a = p.parse_args(argv)

    cfg = LinearConfig()
    cfg.data.data_dir = a.data_dir
    cfg.data.dataset = a.dataset
    cfg.data.crop = a.crop
    cfg.data.aug = a.aug
    cfg.data.image_size = a.image_size[0]
    cfg.data.num_workers = a.num_workers
    cfg.total_batch_size = a.total_batch_size
    cfg.num_classes = a.num_classes
    cfg.model.arch = a.arch
    cfg.optim.base_lr = a.learning_rate
    cfg.optim.lr_scheduler = a.lr_scheduler
    cfg.optim.warmup_epoch = a.warmup_epoch
    cfg.optim.warmup_multiplier = a.warmup_multiplier
    cfg.optim.lr_decay_epochs = a.lr_decay_epochs
    cfg.optim.lr_decay_rate = a.lr_decay_rate
    cfg.optim.weight_decay = a.weight_decay
    cfg.optim.momentum = a.momentum
    cfg.optim.epochs = a.epochs
    cfg.optim.start_epoch = a.start_epoch
    cfg.eval_only = a.eval
    cfg.runtime.output_dir = a.output_dir
    cfg.runtime.auto_resume = a.auto_resume
    cfg.runtime.resume = a.resume
    cfg.runtime.print_freq = a.print_freq
    cfg.runtime.save_freq = a.save_freq
    cfg.runtime.seed = a.seed
    cfg.runtime.compute_dtype = a.compute_dtype
    cfg.runtime.mesh_shape = a.mesh_shape
    return cfg, a.pretrained_model, a.pretrained_branch, a.device


def main(argv: Optional[Sequence[str]] = None):
    cfg, pretrained, branch, device = parse_args(argv)
    from .eval.driver import linear_eval
    from .parallel import init_distributed, shutdown
    ctx, dev = init_distributed(device, mesh_shape=cfg.runtime.mesh_shape)
    try:
        return linear_eval(cfg, pretrained, branch, dev)
    finally:
        shutdown(ctx)


if __name__ == "__main__":
    main()
