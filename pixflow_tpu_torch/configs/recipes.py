"""Named training recipes: the port's own copy of
`pixflow_tpu/configs/recipes.py` (the reference's `tools/*.sh` jobs:
crop 0.08, BYOL aug, LARS base-lr 1.0, wd 1e-5, warmup 5, pixpro-p 2,
momentum 0.99, pos-ratio 0.7, transform-layer 1, instance weight 0)."""

from __future__ import annotations

from .config import (DataConfig, FlowConfig, ModelConfig, OptimConfig,
                     PretrainConfig, RuntimeConfig)


def _canonical_model() -> ModelConfig:
    return ModelConfig(
        arch="resnet50",
        pixpro_p=2.0,
        pixpro_momentum=0.99,
        pixpro_pos_ratio=0.7,
        pixpro_transform_layer=1,
        pixpro_ins_loss_weight=0.0,
    )


def _canonical_optim(epochs: int) -> OptimConfig:
    return OptimConfig(
        optimizer="lars", base_lr=1.0, lr_scheduler="cosine",
        warmup_epoch=5, warmup_multiplier=100.0, weight_decay=1e-5,
        momentum=0.9, epochs=epochs,
    )


def bdd100k_2000ep() -> PretrainConfig:
    """No-flow baseline: global batch 1024 over 8 replicas, n_frames 1."""
    return PretrainConfig(
        data=DataConfig(dataset="bdd100k", aug="BYOL", crop=0.08,
                        image_size=224, n_frames=1, batch_size=128),
        flow=FlowConfig(use_flow=False),
        model=_canonical_model(),
        optim=_canonical_optim(2000),
        runtime=RuntimeConfig(compute_dtype="bfloat16"),
    )


def _flow_recipe(n_frames: int) -> PretrainConfig:
    """Flow recipes: per-replica batch 64, precomputed RAFT-small flows
    (n_frames - 1 of them), upflow8 (lazy), cycle mask alpha1=0.01
    alpha2=0.5; bf16 compute over f32 params, EMA and optimizer state."""
    return PretrainConfig(
        data=DataConfig(dataset="bdd100k", aug="BYOL", crop=0.08,
                        image_size=224, n_frames=n_frames, batch_size=64),
        flow=FlowConfig(use_flow=True, use_flow_file=True, flow_up=True,
                        small=True, alpha1=0.01, alpha2=0.5, flow_bs=2),
        model=_canonical_model(),
        optim=_canonical_optim(2000),
        runtime=RuntimeConfig(compute_dtype="bfloat16"),
    )


def bdd100k_2000ep_nframe2() -> PretrainConfig:
    return _flow_recipe(2)


def bdd100k_2000ep_nframe6() -> PretrainConfig:
    return _flow_recipe(6)


def smoke_cpu() -> PretrainConfig:
    """Tiny smoke config: 96 px crops, batch 8, no flow, f32."""
    return PretrainConfig(
        data=DataConfig(dataset="bdd100k", aug="BYOL", crop=0.2,
                        image_size=96, n_frames=1, batch_size=8,
                        num_workers=0),
        flow=FlowConfig(use_flow=False),
        model=_canonical_model(),
        optim=_canonical_optim(2),
        runtime=RuntimeConfig(compute_dtype="float32"),
    )


RECIPES = {
    "pretrain_bdd100k_2000ep": bdd100k_2000ep,
    "pretrain_bdd100k_2000ep_nframe2": bdd100k_2000ep_nframe2,
    "pretrain_bdd100k_2000ep_nframe6": bdd100k_2000ep_nframe6,
    "smoke_cpu": smoke_cpu,
}


def get_recipe(name: str) -> PretrainConfig:
    if name not in RECIPES:
        raise KeyError(f"unknown recipe '{name}'; choose from {sorted(RECIPES)}")
    return RECIPES[name]()
