"""Typed pretraining configuration: the port's own copy of
`pixflow_tpu/configs/config.py` (same sections, fields and defaults, so a
`config.json` written by either package loads in the other).

Fields that only the JAX package reads so far (loader backends, checkpoint
backends, live RAFT) are kept so the two stay interchangeable; the port
reads so far `data.batch_size/image_size/n_frames`, `flow.*` for the
lazy flow_up path, `model.*`, `optim.*`, and `runtime.compute_dtype/seed/
print_freq`."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass
class DataConfig:
    data_dir: str = "./data"
    dataset: str = "bdd100k"
    ann_file: str = ""
    zip_mode: bool = False
    cache_mode: str = "part"
    aug: str = "BYOL"
    crop: float = 0.08
    crop_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    image_size: int = 224
    n_frames: int = 1
    num_workers: int = 4
    decode_scale: int = 1
    native_decode: bool = False
    restart_transcode: bool = False
    worker_mode: str = "thread"
    loader_backend: str = "native"
    device_aug: bool = False
    batch_size: int = 64               # per replica
    uint8_transfer: bool = True
    flow_transfer_dtype: str = "float16"


@dataclass
class FlowConfig:
    use_flow: bool = False
    use_flow_file: bool = False
    flow_root: str = ""
    fwd_name: str = "forward"
    bwd_name: str = "backward"
    flow_model: str = ""
    small: bool = False
    flow_up: bool = False              # 8x upsample before composing
    flow_up_lazy: bool = True          # point-domain flow_up (the only one here)
    flow_cat_norm: bool = False        # compose in normalized units
    use_flow_frames: bool = False      # multi-span (not ported yet)
    alpha1: Optional[float] = None     # cycle-consistency coefficients
    alpha2: Optional[float] = None
    flow_bs: Optional[int] = None
    raft_iters: int = 12
    raft_dtype: str = "float32"
    raft_corr_dtype: str = "follow"


@dataclass
class ModelConfig:
    model: str = "PixPro"
    arch: str = "resnet50"
    feature_dim: int = 256
    head_type: str = "early_return"
    pixpro_p: float = 1.0
    pixpro_momentum: float = 0.99
    pixpro_pos_ratio: float = 0.7
    pixpro_clamp_value: float = 0.0
    pixpro_transform_layer: int = 0
    pixpro_ins_loss_weight: float = 0.0
    fuse_views: bool = True            # one 2B pass per branch, per-view BN


@dataclass
class OptimConfig:
    optimizer: str = "lars"            # 'sgd' | 'lars'
    base_lr: float = 1.0               # per-256 base
    lr_scheduler: str = "cosine"       # 'cosine' | 'step'
    warmup_epoch: int = 5
    warmup_multiplier: float = 100.0
    lr_decay_epochs: Sequence[int] = (120, 160, 200)
    lr_decay_rate: float = 0.1
    weight_decay: float = 1e-5
    momentum: float = 0.9
    epochs: int = 100
    start_epoch: int = 1


@dataclass
class RuntimeConfig:
    output_dir: str = "./output"
    auto_resume: bool = False
    resume: str = ""
    pretrained_model: str = ""
    print_freq: int = 100              # logged steps also run flow telemetry
    save_freq: int = 10
    debug: bool = False
    debug_epochs: Optional[int] = None
    verbose: bool = False
    seed: int = 0
    compute_dtype: str = "bfloat16"    # 'bfloat16' (autocast) | 'float32'
    mesh_shape: Optional[int] = None
    profile_dir: str = ""
    mask_ratio_exact: bool = False
    checkpoint_backend: str = "msgpack"
    preempt_vote_steps: int = 16
    tensorboard: bool = True
    wandb: bool = False
    wandb_project: str = "pixflow-tpu"
    wandb_entity: str = ""


@dataclass
class PretrainConfig:
    data: DataConfig = field(default_factory=DataConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def to_json(self, **kw) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "PretrainConfig":
        return cls(
            data=DataConfig(**d.get("data", {})),
            flow=FlowConfig(**d.get("flow", {})),
            model=ModelConfig(**d.get("model", {})),
            optim=OptimConfig(**d.get("optim", {})),
            runtime=RuntimeConfig(**d.get("runtime", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "PretrainConfig":
        return cls.from_dict(json.loads(s))
