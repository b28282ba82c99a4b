"""Configuration dataclasses of the four stages (counterpart of
sm3x/core/config.py, with the same class and field names, plus
`RunConfig.device`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from sm3x_torch import NUM_CLASSES


@dataclasses.dataclass
class DataConfig:
    data_name: str = "SevenPCBaseDataset"
    data_path: str = "./data/7PC"
    img_sz: Tuple[int, int] = (224, 224)
    n_classes: Optional[int] = None
    # Derm7pt statistics (run.sh)
    mean: Tuple[float, float, float] = (0.7833, 0.6712, 0.6026)
    std: Tuple[float, float, float] = (0.2139, 0.2472, 0.2571)
    cache_images: bool = True
    cache_size: int = 320
    device_feed: str = "auto"
    hbm_data_budget_mb: int = 4096
    prefetch_depth: int = 2
    crop_amount: int = 25
    size_crops: Tuple[int, ...] = (224, 96)
    nmb_crops: Tuple[int, ...] = (2, 6)
    min_scale_crops: Tuple[float, ...] = (0.5, 0.14)
    max_scale_crops: Tuple[float, ...] = (1.0, 0.5)


@dataclasses.dataclass
class ModelConfig:
    arch: str = "resnet50"
    arch_version: str = "v32"
    arch_weights: Optional[str] = None
    proj_dim: int = 128
    temperature: float = 0.1
    use_checkpoint: Union[bool, str] = False
    finetune: str = "fc"               # the eval stages: fc | projector | all
    # the MLC head of stage 2
    num_labels: int = 8
    extractor_proj_dim: int = 128
    mlc_proj: str = "v4"
    mlc_proj_dim: int = 512
    num_heads: int = 1
    sa_dim_ff: int = 128
    sa_dropout: float = 0.1
    l2_norm: bool = False
    init_prototype: bool = False
    finetune_backbone: bool = False
    num_classes: Tuple[int, ...] = tuple(NUM_CLASSES)
    use_pallas_ntxent: bool = False
    use_pallas_augment: bool = False
    negatives: str = "local"
    local_loss_weight: float = 1.0
    bn_stat_freq: int = 1
    # --arch-version trimodal: the cardinality of each metadata field
    # (elevation, sex, location); the CLI takes them from the training data
    meta_vocab_sizes: Tuple[int, ...] = (4, 4, 16)


@dataclasses.dataclass
class OptimConfig:
    epochs: int = 100
    batch_size: int = 64               # global batch
    base_lr: float = 1e-3
    final_lr: float = 0.0
    momentum: float = 0.9
    wd: float = 5e-2
    warmup_epochs: int = 10
    start_warmup: float = 0.0
    use_lr_schedule: bool = False
    ft_lr: float = 1e-3
    adam_eps: float = 1e-5             # the stage-1 AdamW eps
    label_weights: Tuple[float, ...] = (1.0,) * 8
    amp: bool = True                   # bf16 autocast around the encoders


@dataclasses.dataclass
class RunConfig:
    seed: int = 3407
    workers: int = 8
    save_freq: int = 50
    ckpt_freq: int = 1
    ckpt_backend: str = "msgpack"
    ckpt_keep: int = 3
    print_freq: int = 50
    nan_guard: bool = False
    save_on_preempt: bool = False
    resume_path: Optional[str] = None
    pretrain_path: Optional[str] = None
    log_path: str = "./logs"
    logger_name: Optional[str] = None
    tensorboard: bool = False
    wandb: bool = False
    proj_name: str = "sm3x"
    run_group: Optional[str] = None
    run_name: Optional[str] = None
    run_type: str = "train"
    comments: str = "sm3x training"
    mesh_data: Optional[int] = None
    mesh_model: int = 1
    # logical world size for local-negative grouping; None = 1 here
    world_size: Optional[int] = None
    # the port's device ("cuda", "cuda:1", "cpu"); chosen explicitly
    device: str = "cuda"


@dataclasses.dataclass
class SSLConfig:
    """Stage-1 SSL pretraining (run.sh stage1_ssl)."""
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(
        default_factory=lambda: OptimConfig(epochs=400, batch_size=96,
                                            base_lr=1e-6))
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    n_views: int = 2
    modality_weights: Tuple[float, float] = (1.0, 1.0)


@dataclasses.dataclass
class MLCTrainConfig:
    """Stage-2 DeepCluster MLC training (run.sh stage2_mlc)."""
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(
        default_factory=lambda: ModelConfig(temperature=1.0))
    optim: OptimConfig = dataclasses.field(
        default_factory=lambda: OptimConfig(epochs=150, batch_size=256,
                                            base_lr=1e-4))
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    extractor_weights: Optional[str] = None
    kmeans_iters: int = 10


@dataclasses.dataclass
class EvalConfig:
    """Supervised eval / finetune (run.sh stage1_eval and stage2_eval)."""
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(
        default_factory=lambda: OptimConfig(epochs=100, batch_size=128,
                                            base_lr=1e-3))
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    train_sz: int = 224
    test_sz: int = 224


def asdict_flat(cfg) -> dict:
    """Flatten a nested config into {'optim.base_lr': ...} for configs.txt."""
    out = {}

    def rec(prefix, obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                rec(f"{prefix}{f.name}.", v)
            else:
                out[f"{prefix}{f.name}"] = v

    rec("", cfg)
    return out
