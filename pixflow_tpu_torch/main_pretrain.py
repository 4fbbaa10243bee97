"""PixPro(+optical-flow) pretraining CLI of the PyTorch/CUDA port:

    python -m pixflow_tpu_torch.main_pretrain \\
        --recipe pretrain_bdd100k_2000ep_nframe6 --data-dir DATA --output-dir OUT

The flag surface and the recipe-override rule are those of the JAX
package's `main_pretrain.py` (itself the reference's `main_pretrain.py` +
`contrast/option.py`), so job scripts carry over: a flag given on the
command line overrides the recipe's value, a flag left out keeps it. One
addition: `--device` (default `cuda`; `--device cpu` runs on the CPU, as
the tests do); a missing card is an error, never a fall-back to the CPU.
Flags whose path the port does not have yet raise NotImplementedError
naming their ROADMAP.md item (`train/driver.py:check_ported`).

Data parallel, one process a card: start N ranks with
`torchrun --nproc_per_node N -m pixflow_tpu_torch.main_pretrain_multihost
...` (or this module with `--multihost`); `--batch-size` is per rank and
`--mesh-shape`, when given, must equal N (`parallel/dist.py`)."""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from .configs import PretrainConfig, RECIPES, get_recipe


def parse_args(argv: Optional[Sequence[str]] = None):
    """(PretrainConfig, device, multihost) from the command line."""
    p = argparse.ArgumentParser("pixflow-tpu pre-train stage (PyTorch/CUDA port)")

    p.add_argument("--recipe", type=str, default="",
                   help=f"named recipe from {sorted(RECIPES)}")

    # dataset
    p.add_argument("--data-dir", type=str, default="./data")
    p.add_argument("--crop", type=float, default=0.08)
    p.add_argument("--crop-ratio", nargs=2, type=float, default=[3 / 4, 4 / 3])
    p.add_argument("--aug", type=str, default="BYOL",
                   choices=["NULL", "InstDisc", "MoCov2", "SimCLR", "RandAug",
                            "BYOL", "val"])
    p.add_argument("--zip", action="store_true")
    p.add_argument("--cache-mode", type=str, default="part",
                   choices=["no", "full", "part"])
    p.add_argument("--dataset", type=str, default="bdd100k",
                   choices=["ImageNet", "bdd100k"])
    p.add_argument("--ann-file", type=str, default="")
    p.add_argument("--image-size", nargs="+", type=int, default=[224])
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--decode-scale", type=int, default=1,
                   choices=[1, 2, 4, 8],
                   help="JPEG draft decode downscale: cheaper host "
                        "decode, near-identical pair geometry (O(1/W) "
                        "boundary effects; see data/datasets.py:load_image)")
    p.add_argument("--native-decode", action="store_true",
                   help="native libjpeg ROI decode fused with crop+resize "
                        "(identical crop sampling; builds native/jpegroi.cpp "
                        "with g++ -ljpeg at first use)")
    p.add_argument("--restart-transcode", action="store_true",
                   help="with --native-decode and a byte cache: lossless "
                        "restart-marker transcode at cache time so crop "
                        "decodes skip entropy work above their band "
                        "(identical pixels; on-disk corpora: "
                        "tools/transcode_restart.py)")
    p.add_argument("--worker-mode", type=str, default="thread",
                   choices=["thread", "process"],
                   help="decode workers: in-process threads or "
                        "forked processes (GIL-free decode)")
    p.add_argument("--loader-backend", type=str, default="native",
                   choices=["native", "grain"],
                   help="host input backend: built-in ShardedLoader, or "
                        "Google Grain (not ported)")
    p.add_argument("--checkpoint-backend", type=str, default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="single atomic checkpoint files (written with "
                        "torch.save in the port), or orbax (not ported)")
    p.add_argument("--preempt-vote-steps", type=int, default=16,
                   help="multi-process SIGTERM vote cadence (kept for the "
                        "flag surface; one process polls every step)")
    p.add_argument("--wandb", action="store_true",
                   help="log to Weights & Biases (not ported)")
    p.add_argument("--wandb-project", type=str, default="pixflow-tpu")
    p.add_argument("--wandb-entity", type=str, default="")
    p.add_argument("--mask-ratio-exact", action="store_true",
                   help="log the reference-exact full-field mask ratio "
                        "of each logged batch (materialising composition)")
    p.add_argument("--device-aug", action="store_true",
                   help="photometric augmentation on the device "
                        "(ops/augment.py); the loader only samples it")
    p.add_argument("--n-frames", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=64,
                   help="per-replica batch size")

    # flow / RAFT
    p.add_argument("--use_flow", action="store_true")
    p.add_argument("--flow_model", type=str, default="")
    p.add_argument("--flow_up", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="compose flows at full resolution (upflow8 parity "
                        "mode; --no-flow_up forces 1/8-res composition "
                        "even when the recipe enables it)")
    p.add_argument("--flow_up_lazy", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="evaluate the full-res composition lazily at loss "
                        "points (default); --no-flow_up_lazy materializes "
                        "the 720x1280 fields")
    p.add_argument("--alpha1", type=float, default=None)
    p.add_argument("--alpha2", type=float, default=None)
    p.add_argument("--flow_cat_norm", action="store_true")
    p.add_argument("--flow_bs", type=int, default=None)
    p.add_argument("--raft_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="live RAFT compute dtype; float32 only (bfloat16: "
                        "ROADMAP.md item 9)")
    p.add_argument("--raft_corr_dtype", type=str, default="follow",
                   choices=["follow", "float32", "bfloat16"],
                   help="live RAFT corr-pyramid dtype; follow or float32 only "
                        "(bfloat16: ROADMAP.md item 9)")
    p.add_argument("--use_flow_frames", action="store_true")
    p.add_argument("--use_flow_file", action="store_true")
    p.add_argument("--flow_root", type=str, default="")
    p.add_argument("--fwd_name", type=str, default="forward")
    p.add_argument("--bwd_name", type=str, default="backward")

    # model
    p.add_argument("--model", type=str, default="PixPro")
    p.add_argument("--arch", type=str, default="resnet50")
    p.add_argument("--feature-dim", type=int, default=256)
    p.add_argument("--fuse_views", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="run both views as one fused 2B pass per branch "
                        "(per-view BN stats preserved; default on)")

    # optimization
    p.add_argument("--base-learning-rate", "--base-lr", dest="base_lr",
                   type=float, default=1.0)
    p.add_argument("--optimizer", type=str, default="lars",
                   choices=["sgd", "lars"])
    p.add_argument("--lr-scheduler", type=str, default="cosine",
                   choices=["step", "cosine"])
    p.add_argument("--warmup-epoch", type=int, default=5)
    p.add_argument("--warmup-multiplier", type=float, default=100)
    p.add_argument("--lr-decay-epochs", type=int, nargs="+",
                   default=[120, 160, 200])
    p.add_argument("--lr-decay-rate", type=float, default=0.1)
    p.add_argument("--weight-decay", type=float, default=1e-5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--start-epoch", type=int, default=1)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--debug-epochs", type=int, default=None)

    # pixpro
    p.add_argument("--pixpro-p", type=float, default=1.0)
    p.add_argument("--pixpro-momentum", type=float, default=0.99)
    p.add_argument("--pixpro-pos-ratio", type=float, default=0.7)
    p.add_argument("--pixpro-clamp-value", type=float, default=0.0)
    p.add_argument("--pixpro-transform-layer", type=int, default=0)
    p.add_argument("--pixpro-ins-loss-weight", type=float, default=0.0)
    # accepted for flag-surface parity; the reference declares these but
    # never consumes them (contrast/option.py:101-102)
    p.add_argument("--pixpro-neg-ratio", type=float, default=1.0)
    p.add_argument("--pixpro-neg-loss-weight", type=float, default=1.0)

    # misc
    p.add_argument("--output-dir", type=str, default="./output")
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--pretrained-model", type=str, default="")
    p.add_argument("--print-freq", type=int, default=100)
    p.add_argument("--save-freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true",
                   help="save debug images (not ported)")
    p.add_argument("--verbose", action="store_true")

    # compute and placement
    p.add_argument("--compute-dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="bf16 autocast over f32 weights replaces apex AMP O1; "
                        "float32 = O0")
    p.add_argument("--mesh-shape", type=int, default=None,
                   help="number of ranks in the data mesh, one process a card; "
                        "must equal torchrun's WORLD_SIZE")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group from torchrun's variables "
                        "(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")

    a = p.parse_args(argv)

    cfg = get_recipe(a.recipe) if a.recipe else PretrainConfig()
    d, f, m, o, r = cfg.data, cfg.flow, cfg.model, cfg.optim, cfg.runtime

    defaults = p.parse_args([] if not a.recipe else ["--recipe", a.recipe])

    def given(name):  # only override recipe values for explicitly-passed flags
        return getattr(a, name) != getattr(defaults, name)

    for field_, dst, attr in [
        ("data_dir", d, "data_dir"), ("crop", d, "crop"),
        ("aug", d, "aug"), ("cache_mode", d, "cache_mode"),
        ("dataset", d, "dataset"), ("ann_file", d, "ann_file"),
        ("num_workers", d, "num_workers"), ("n_frames", d, "n_frames"),
        ("worker_mode", d, "worker_mode"),
        ("decode_scale", d, "decode_scale"),
        ("native_decode", d, "native_decode"),
        ("restart_transcode", d, "restart_transcode"),
        ("device_aug", d, "device_aug"),
        ("loader_backend", d, "loader_backend"),
        ("batch_size", d, "batch_size"),
        ("flow_model", f, "flow_model"), ("alpha1", f, "alpha1"),
        ("alpha2", f, "alpha2"), ("flow_bs", f, "flow_bs"),
        ("raft_dtype", f, "raft_dtype"),
        ("raft_corr_dtype", f, "raft_corr_dtype"),
        ("flow_root", f, "flow_root"), ("fwd_name", f, "fwd_name"),
        ("bwd_name", f, "bwd_name"),
        ("arch", m, "arch"), ("feature_dim", m, "feature_dim"),
        ("pixpro_p", m, "pixpro_p"), ("pixpro_momentum", m, "pixpro_momentum"),
        ("pixpro_pos_ratio", m, "pixpro_pos_ratio"),
        ("pixpro_clamp_value", m, "pixpro_clamp_value"),
        ("pixpro_transform_layer", m, "pixpro_transform_layer"),
        ("pixpro_ins_loss_weight", m, "pixpro_ins_loss_weight"),
        ("base_lr", o, "base_lr"), ("optimizer", o, "optimizer"),
        ("lr_scheduler", o, "lr_scheduler"), ("warmup_epoch", o, "warmup_epoch"),
        ("warmup_multiplier", o, "warmup_multiplier"),
        ("lr_decay_epochs", o, "lr_decay_epochs"),
        ("lr_decay_rate", o, "lr_decay_rate"),
        ("weight_decay", o, "weight_decay"), ("momentum", o, "momentum"),
        ("start_epoch", o, "start_epoch"), ("epochs", o, "epochs"),
        ("output_dir", r, "output_dir"), ("auto_resume", r, "auto_resume"),
        ("resume", r, "resume"), ("pretrained_model", r, "pretrained_model"),
        ("print_freq", r, "print_freq"), ("save_freq", r, "save_freq"),
        ("seed", r, "seed"), ("debug", r, "debug"),
        ("debug_epochs", r, "debug_epochs"), ("verbose", r, "verbose"),
        ("compute_dtype", r, "compute_dtype"), ("mesh_shape", r, "mesh_shape"),
        ("mask_ratio_exact", r, "mask_ratio_exact"),
        ("wandb", r, "wandb"), ("wandb_project", r, "wandb_project"),
        ("wandb_entity", r, "wandb_entity"),
        ("checkpoint_backend", r, "checkpoint_backend"),
        ("preempt_vote_steps", r, "preempt_vote_steps"),
    ]:
        if not a.recipe or given(field_):
            setattr(dst, attr, getattr(a, field_))

    if not a.recipe or given("crop_ratio"):
        d.crop_ratio = tuple(a.crop_ratio)
    if not a.recipe or given("image_size"):
        d.image_size = a.image_size[0]
    if not a.recipe or given("zip"):
        d.zip_mode = a.zip
    for flag in ("use_flow", "use_flow_file", "flow_cat_norm",
                 "use_flow_frames"):
        if not a.recipe or given(flag):
            setattr(f, flag, getattr(a, flag))
    # tri-state booleans: None = keep recipe/dataclass default
    if a.flow_up is not None:
        f.flow_up = a.flow_up
    if a.flow_up_lazy is not None:
        f.flow_up_lazy = a.flow_up_lazy
    if a.fuse_views is not None:
        m.fuse_views = a.fuse_views

    # infer RAFT-small from the checkpoint name, like reference option.py:109-113
    if f.flow_model and "small" in os.path.basename(f.flow_model):
        f.small = True

    return cfg, a.device, a.multihost


def main(argv: Optional[Sequence[str]] = None):
    """Train; with torchrun's variables set (required by `--multihost`),
    as one rank of the group they name."""
    from .parallel import init_distributed, shutdown
    from .train.driver import check_ported, train

    cfg, device, multihost = parse_args(argv)
    check_ported(cfg)
    ctx, dev = init_distributed(device, mesh_shape=cfg.runtime.mesh_shape,
                                require_env=multihost)
    try:
        return train(cfg, dev)
    finally:
        shutdown(ctx)


if __name__ == "__main__":
    main()
