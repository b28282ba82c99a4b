"""Argparse surface of the port's four stages (counterpart of
sm3x/cli/parser.py `get_parser`, `ssl_config`, `mlc_train_config` and
`eval_config`, with the flags that each app of sm3x/cli/apps.py adds).

The flags and defaults are the JAX package's, plus `--device` (default
`cuda`). Values the port does not support yet are refused by the trainer
(`unsupported` in `sm3x_torch.train.backbone_train`, `mlc_train` and
`supervised`) and by the app, never silently ignored.
"""

from __future__ import annotations

import argparse

from sm3x_torch.core.config import (DataConfig, EvalConfig, MLCTrainConfig,
                                    ModelConfig, OptimConfig, RunConfig,
                                    SSLConfig)


def get_parser(desc: str = "sm3x_torch SimCLR skin SSL training"):
    p = argparse.ArgumentParser(description=desc)
    # data
    p.add_argument("--data-name", type=str, default="SevenPCBaseDataset")
    p.add_argument("--data-path", type=str, default="./data/7PC")
    p.add_argument("--img-sz", nargs=2, type=int, default=[224, 224])
    p.add_argument("--n-classes", type=int, default=None)
    p.add_argument("--mean", nargs=3, type=float,
                   default=[0.485, 0.456, 0.406])
    p.add_argument("--std", nargs=3, type=float, default=[0.229, 0.224, 0.225])
    p.add_argument("--cache-size", type=int, default=320,
                   help="host decode canvas")
    p.add_argument("--no-cache-images", dest="cache_images",
                   action="store_false", default=True)
    p.add_argument("--device-feed", type=str, default="auto",
                   choices=["auto", "resident", "prefetch", "host"])
    p.add_argument("--hbm-data-budget-mb", type=int, default=4096)
    p.add_argument("--prefetch-depth", type=int, default=2)
    p.add_argument("--size-crops", nargs="*", type=int, default=[224, 96])
    p.add_argument("--nmb-crops", nargs="*", type=int, default=[2, 6])
    p.add_argument("--min-scale-crops", nargs="*", type=float,
                   default=[0.5, 0.14])
    p.add_argument("--max-scale-crops", nargs="*", type=float,
                   default=[1.0, 0.5])
    p.add_argument("--local-loss-weight", type=float, default=1.0)
    # model
    p.add_argument("-a", "--arch", default="resnet18", type=str)
    p.add_argument("--finetune", default="fc", type=str)
    # optim
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("-b", "--batch-size", default=64, type=int,
                   help="global batch size")
    p.add_argument("-lr", "--base-lr", default=1e-3, type=float)
    p.add_argument("--final-lr", type=float, default=0)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", default=5e-2, type=float)
    p.add_argument("--warmup-epochs", default=10, type=int)
    p.add_argument("--start-warmup", default=0, type=float)
    p.add_argument("--use-lr-schedule", action="store_true")
    # distribution
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--world-size", default=None, type=int,
                   help="number of groups that NT-Xent negatives stay "
                   "local to (the reference's GPU count)")
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    # misc
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("--save-freq", type=int, default=50)
    p.add_argument("--ckpt-freq", type=int, default=1)
    p.add_argument("--ckpt-backend", choices=("msgpack", "orbax"),
                   default="msgpack")
    p.add_argument("--ckpt-keep", type=int, default=3)
    p.add_argument("--print-freq", type=int, default=50)
    p.add_argument("--nan-guard", action="store_true")
    p.add_argument("--save-on-preempt", action="store_true")
    p.add_argument("--use-pallas-augment", action="store_true",
                   help="accepted for parity: on CUDA the photometric "
                   "chain always runs as the port's kernel")
    p.add_argument("--amp", action="store_true",
                   help="bf16 autocast around the encoders")
    p.add_argument("--resume-path", type=str, default=None)
    p.add_argument("--pretrain-path", type=str, default=None)
    p.add_argument("--log-path", type=str, default="./logs")
    p.add_argument("--logger-name", type=str, default=None)
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--run-group", default=None, type=str)
    p.add_argument("--run-name", default=None, type=str)
    p.add_argument("--run-tag", nargs="*", default=None, type=str)
    p.add_argument("--run-type", default="train", type=str)
    p.add_argument("--comments", default="sm3x training", type=str)
    p.add_argument("--proj-name", type=str, default="sm3x")
    # the port
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p


def add_ssl_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The stage-1 flags of the JAX package's backbone_train app."""
    p.add_argument("--arch-version", type=str, default="v3")
    p.add_argument("--arch-weights", type=str, default=None)
    p.add_argument("--ft-lr", default=1e-3, type=float)
    p.add_argument("--proj-dim", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.5)
    p.add_argument("--modality-weights", nargs=2, type=float,
                   default=[1.0, 1.0])
    p.add_argument("--num-labels", type=int, default=8)
    p.add_argument("--label-weights", nargs="*", type=float,
                   default=[1.0] * 8)
    p.add_argument("--use-checkpoint", nargs="?", const=True, default=False,
                   choices=("off", "dots", "attn", "flash", "mlp", "attn_mlp"),
                   help="activation-memory mode (ViT backbones): bare flag = "
                   "per-block checkpoint; 'dots' = save the weight matmuls' "
                   "outputs only; 'attn' = recompute the attention internals; "
                   "'flash' = flash-attention kernels on the card; 'mlp' = "
                   "recompute ln2+fc1+gelu; 'attn_mlp' = both; 'off' = save "
                   "everything. A ViT defaults to 'attn'")
    p.add_argument("--use-pallas-ntxent", action="store_true",
                   help="accepted for parity: on CUDA the NT-Xent loss "
                   "always runs as the port's kernel")
    p.add_argument("--negatives", choices=("local", "global"),
                   default="local")
    p.add_argument("--bn-stat-freq", type=int, default=1,
                   help="EXPERIMENTAL throughput knob: refresh BN batch "
                   "statistics only every K-th step; the other steps "
                   "normalize with running stats (eval-BN forward, no stat "
                   "pass). Measured HARMFUL to learned-feature quality in a "
                   "learning-regime grid at lr 1e-5 (K=4 probe lands below "
                   "the random-init control — BENCH.md round 4); keep at 1 "
                   "(reference semantics) for quality-critical runs")
    p.add_argument("--linear-probe", action="store_true",
                   help="run the in-tool linear probe after training")
    p.add_argument("--probe-epochs", type=int, default=50,
                   help="epochs of the in-tool linear probe (the port's "
                   "flag; the reference fixes 50)")
    return p


def add_mlc_train_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The stage-2 flags of the JAX package's mlc_train app, with its
    defaults (run.sh sets --mlc-proj-dim 512, --sa-dim-ff 128 and
    --temperature 1)."""
    p.add_argument("--num-labels", type=int, default=8)
    p.add_argument("--extractor-proj-dim", type=int, default=128)
    p.add_argument("--extractor-weights", type=str, default=None,
                   help="a stage-1 ckp_*.pth of the port: its two encoders "
                   "are loaded, its projectors dropped")
    p.add_argument("--mlc-proj", type=str, default="v4")
    p.add_argument("--mlc-proj-dim", type=int, default=256)
    p.add_argument("--num-heads", type=int, default=1)
    p.add_argument("--sa-dim-ff", type=int, default=256)
    p.add_argument("--sa-dropout", type=float, default=0.1)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--l2-norm", action="store_true")
    p.add_argument("--finetune-backbone", action="store_true")
    return p


def add_mlc_eval_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags of the JAX package's mlc_eval app, with its defaults
    (run.sh sets --mlc-proj-dim 512 and --sa-dim-ff 128)."""
    p.add_argument("--mlc-proj", type=str, default="v4")
    p.add_argument("--mlc-proj-dim", type=int, default=256)
    p.add_argument("--num-heads", type=int, default=1)
    p.add_argument("--sa-dim-ff", type=int, default=256)
    p.add_argument("--sa-dropout", type=float, default=0.1)
    p.add_argument("--arch-weights", type=str, default=None)
    p.add_argument("--extractor-proj-dim", type=int, default=128)
    p.add_argument("--num-labels", type=int, default=8)
    p.add_argument("--label-weights", nargs="*", type=float,
                   default=[1.0] * 8)
    p.add_argument("--l2-norm", action="store_true")
    p.add_argument("--init-prototype", action="store_true")
    p.add_argument("--train-sz", type=int, default=224)
    p.add_argument("--test-sz", type=int, default=224)
    return p


def add_backbone_eval_args(p: argparse.ArgumentParser
                           ) -> argparse.ArgumentParser:
    """The flags of the JAX package's backbone_eval app."""
    p.add_argument("--num-labels", type=int, default=8)
    p.add_argument("--label-weights", nargs="*", type=float,
                   default=[1.0] * 8)
    return p


def base_configs(args) -> tuple:
    """The (data, optim, run) configs every stage builds from the shared
    flags; flags a stage's parser lacks keep their defaults."""
    data = DataConfig(
        data_name=args.data_name, data_path=args.data_path,
        img_sz=tuple(args.img_sz), n_classes=args.n_classes,
        mean=tuple(args.mean), std=tuple(args.std),
        cache_size=args.cache_size, cache_images=args.cache_images,
        device_feed=args.device_feed,
        hbm_data_budget_mb=args.hbm_data_budget_mb,
        prefetch_depth=args.prefetch_depth,
        size_crops=tuple(args.size_crops), nmb_crops=tuple(args.nmb_crops),
        min_scale_crops=tuple(args.min_scale_crops),
        max_scale_crops=tuple(args.max_scale_crops))
    optim = OptimConfig(
        epochs=args.epochs, batch_size=args.batch_size, base_lr=args.base_lr,
        final_lr=args.final_lr, momentum=args.momentum, wd=args.wd,
        warmup_epochs=args.warmup_epochs, start_warmup=args.start_warmup,
        use_lr_schedule=args.use_lr_schedule, amp=args.amp,
        ft_lr=getattr(args, "ft_lr", 1e-3),
        label_weights=tuple(getattr(args, "label_weights", (1.0,) * 8)))
    run = RunConfig(
        seed=args.seed, workers=args.workers, save_freq=args.save_freq,
        ckpt_freq=args.ckpt_freq, ckpt_backend=args.ckpt_backend,
        ckpt_keep=args.ckpt_keep, print_freq=args.print_freq,
        nan_guard=args.nan_guard, save_on_preempt=args.save_on_preempt,
        resume_path=args.resume_path, pretrain_path=args.pretrain_path,
        log_path=args.log_path, logger_name=args.logger_name,
        tensorboard=args.tensorboard, wandb=args.wandb,
        proj_name=args.proj_name, run_group=args.run_group,
        run_name=args.run_name, run_type=args.run_type,
        comments=args.comments, mesh_data=args.mesh_data,
        mesh_model=args.mesh_model, world_size=args.world_size,
        device=args.device)
    return data, optim, run


def ssl_config(args) -> SSLConfig:
    data, optim, run = base_configs(args)
    model = ModelConfig(
        arch=args.arch, arch_version=args.arch_version,
        arch_weights=args.arch_weights, proj_dim=args.proj_dim,
        temperature=args.temperature, use_checkpoint=args.use_checkpoint,
        num_labels=args.num_labels,
        use_pallas_ntxent=args.use_pallas_ntxent,
        use_pallas_augment=args.use_pallas_augment,
        negatives=args.negatives, local_loss_weight=args.local_loss_weight,
        bn_stat_freq=args.bn_stat_freq)
    return SSLConfig(data=data, model=model, optim=optim, run=run,
                     modality_weights=tuple(args.modality_weights))


def mlc_train_config(args) -> MLCTrainConfig:
    data, optim, run = base_configs(args)
    model = ModelConfig(
        arch=args.arch, num_labels=args.num_labels,
        extractor_proj_dim=args.extractor_proj_dim, mlc_proj=args.mlc_proj,
        mlc_proj_dim=args.mlc_proj_dim, num_heads=args.num_heads,
        sa_dim_ff=args.sa_dim_ff, sa_dropout=args.sa_dropout,
        temperature=args.temperature, l2_norm=args.l2_norm,
        finetune_backbone=args.finetune_backbone,
        use_pallas_augment=args.use_pallas_augment)
    return MLCTrainConfig(data=data, model=model, optim=optim, run=run,
                          extractor_weights=args.extractor_weights)


def eval_config(args, train_sz=None, test_sz=None) -> EvalConfig:
    """Both eval apps; flags that only mlc_eval's parser has keep the
    run.sh recipe's values for backbone_eval."""
    data, optim, run = base_configs(args)
    model = ModelConfig(
        arch=args.arch, finetune=args.finetune,
        arch_weights=getattr(args, "arch_weights", None),
        num_labels=getattr(args, "num_labels", 8),
        extractor_proj_dim=getattr(args, "extractor_proj_dim", 128),
        mlc_proj=getattr(args, "mlc_proj", "v4"),
        mlc_proj_dim=getattr(args, "mlc_proj_dim", 512),
        num_heads=getattr(args, "num_heads", 1),
        sa_dim_ff=getattr(args, "sa_dim_ff", 128),
        sa_dropout=getattr(args, "sa_dropout", 0.1),
        l2_norm=getattr(args, "l2_norm", False),
        init_prototype=getattr(args, "init_prototype", False),
        use_pallas_augment=args.use_pallas_augment)
    return EvalConfig(
        data=data, model=model, optim=optim, run=run,
        train_sz=train_sz or getattr(args, "train_sz", 224),
        test_sz=test_sz or getattr(args, "test_sz", 224))
