"""Stage-1 SSL pretraining (counterpart of sm3x/train/backbone_train.py:
`make_ssl_train_step` :30-144, `SSLTrainer` :193-493).

One step, after the uint8 canvases reach the device:
  2 augmented views per modality (RRC as torch.bmm, photometric chain as
  kernel K1) -> SimCLRSkinV3/V32 with ResNet or ViT encoders (bf16 autocast
  around the encoders; a ViT with --use-checkpoint flash runs its attention
  as kernels K3f / K3b-dq / K3b-dkv) -> ssl_loss (all NT-Xent terms and
  groups as one K2 call) -> backward (K2b for the loss) -> AdamW.

Randomness: each step's seed is `prng.step_seed(seed, epoch, step)`; the
derm and clinic streams fold in 0 and 1, each view folds in its index, and
each view draws from its own `torch.Generator` on the device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from sm3x_torch.core import prng
from sm3x_torch.losses.ssl import ssl_loss
from sm3x_torch.models.backbones import is_vit
from sm3x_torch.models.simclr import build_ssl_model
from sm3x_torch.ops.augment import (SSL_AUG, modality_keys, modality_valid_hw,
                                    ssl_augment_batch)
from sm3x_torch.train import common
from sm3x_torch.utils.logging import StatWriter
from sm3x_torch.utils.misc import AverageMeter, ProgressMeter, setup_logger

DATASETS = ("SevenPCBaseDataset", "SevenPCBaseDataset2")


def unsupported(cfg) -> list:
    """Settings of `cfg` outside what the port's stage 1 does yet, each with
    where it stands; an empty list when the run is within the slice."""
    m, o, r, d = cfg.model, cfg.optim, cfg.run, cfg.data
    later = "is not in the PyTorch port yet (ROADMAP.md)"
    checks = [
        (m.arch_version == "trimodal", f"--arch-version trimodal {later}"),
        (d.data_name not in DATASETS,
         f"--data-name {d.data_name}: the port's stage 1 takes "
         f"{' or '.join(DATASETS)} (multi-crop SevenPCSwavDataset {later})"),
        (m.bn_stat_freq != 1, f"--bn-stat-freq {m.bn_stat_freq} is not ported "
         f"(measured harmful to feature quality, BENCH.md r4)"),
        (bool(m.arch_weights), f"--arch-weights {later}"),
        (o.use_lr_schedule, f"--use-lr-schedule {later}"),
        (r.mesh_model != 1 or (r.mesh_data or 1) != 1,
         f"a device mesh (--mesh-data/--mesh-model) {later}; the port's "
         f"stage 1 runs on one device (--world-size only groups negatives)"),
        (r.ckpt_backend != "msgpack", f"--ckpt-backend {r.ckpt_backend} "
         f"{later}"),
        (r.save_on_preempt, f"--save-on-preempt {later}"),
        (not d.cache_images, f"--no-cache-images (streaming) {later}"),
        (d.device_feed not in ("auto", "host"),
         f"--device-feed {d.device_feed} {later}; batches are uploaded "
         f"each step"),
        (m.negatives not in ("local", "global"),
         f"--negatives {m.negatives}"),
    ]
    return [msg for bad, msg in checks if bad]


def resolve_remat(use_checkpoint, arch: str, logger=None):
    """--use-checkpoint -> the encoder's remat mode, as the JAX trainer
    resolves it (sm3x/train/backbone_train.py:224-232): a ViT defaults to
    'attn' (recompute only the attention internals), 'off' is False."""
    if use_checkpoint is False and is_vit(arch):
        if logger is not None:
            logger.info("ViT backbone: defaulting --use-checkpoint to 'attn' "
                        "(pass --use-checkpoint off to save every residual)")
        return "attn"
    return False if use_checkpoint == "off" else use_checkpoint


def augment_views(seed: int, canvases, valid_hw, mean, std, cfg):
    """Two views of one modality, each from its own generator."""
    dev = canvases.device
    return tuple(ssl_augment_batch(prng.generator(prng.fold_in(seed, v), dev),
                                   canvases, valid_hw, mean, std, cfg)
                 for v in range(2))


def ssl_update(model, optimizer, derm_views, clinic_views, style: int,
               temperature: float, groups: int,
               modality_weights=(1.0, 1.0)) -> dict:
    """Forward, loss, backward and AdamW step on augmented views. Returns
    detached device scalars (read them back when needed)."""
    optimizer.zero_grad(set_to_none=True)
    outs = model(derm_views, clinic_views)
    total, parts = ssl_loss(outs, style, temperature, groups,
                            modality_weights=modality_weights)
    total.backward()
    optimizer.step()
    return {"loss": total.detach(),
            **{k: v.detach() for k, v in parts.items()}}


def make_ssl_train_step(model, optimizer, style: int, temperature: float,
                        groups: int, mean, std, aug_cfg=SSL_AUG,
                        modality_weights=(1.0, 1.0), joint_aug: bool = False):
    """Returns step(derm, derm_hw, clinic, clinic_hw, seed) -> metrics, with
    the canvases (B, S, S, 3) uint8 and valid sizes (B, 2) on the device.
    `joint_aug` (SevenPCBaseDataset2) gives the derm/clinic pair the same
    augmentation parameters within their common valid region. On the card
    the photometric chain and the loss always run kernels K1 and K2, so
    --use-pallas-augment / --use-pallas-ntxent change nothing here."""

    def train_step(derm, derm_hw, clinic, clinic_hw, seed: int) -> dict:
        kd, kc = modality_keys(prng.fold_in(seed, 0), prng.fold_in(seed, 1),
                               joint_aug)
        d_hw, c_hw = modality_valid_hw(derm_hw, clinic_hw, joint_aug)
        d = augment_views(kd, derm, d_hw, mean, std, aug_cfg)
        c = augment_views(kc, clinic, c_hw, mean, std, aug_cfg)
        return ssl_update(model, optimizer, d, c, style, temperature, groups,
                          modality_weights)

    return train_step


class SSLTrainer(common.CheckpointableTrainer):
    """Owns the model, the optimizer and the epoch loop on one device; its
    checkpoints have `export_simclr_skin`'s key layout."""

    def __init__(self, cfg, logger=None):
        problems = unsupported(cfg)
        if problems:
            raise ValueError("; ".join(problems))
        self.cfg = cfg
        self.device = torch.device(cfg.run.device)
        self.logger = logger or setup_logger(cfg.run.log_path,
                                             "sm3x_torch.ssl")
        self.writer = StatWriter(cfg.run.log_path, cfg.run.tensorboard,
                                 cfg.run.wandb, cfg.run.proj_name,
                                 logger=self.logger)
        m = cfg.model
        self.remat = resolve_remat(m.use_checkpoint, m.arch, self.logger)
        # initialise from the seed on the CPU, whatever the device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(prng.fold_in(cfg.run.seed, 0))
            self.model, self.style = build_ssl_model(
                m.arch_version, m.arch, m.proj_dim, amp=cfg.optim.amp,
                remat=self.remat, img_size=tuple(cfg.data.img_sz))
        self.model.to(self.device)
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        self.model.train()
        # per-device-negatives parity: world_size groups
        self.groups = 1 if m.negatives == "global" else (
            cfg.run.world_size or 1)
        self.optimizer = common.make_adamw(
            self.model.parameters(), cfg.optim.base_lr, cfg.optim.wd,
            eps=cfg.optim.adam_eps)
        aug_cfg = dataclasses.replace(SSL_AUG, out_size=tuple(cfg.data.img_sz))
        self.train_step = make_ssl_train_step(
            self.model, self.optimizer, self.style, m.temperature,
            self.groups, tuple(cfg.data.mean), tuple(cfg.data.std), aug_cfg,
            modality_weights=tuple(cfg.modality_weights),
            joint_aug=cfg.data.data_name == "SevenPCBaseDataset2")

    def _upload(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def train_epoch(self, data, epoch: int) -> dict:
        """One pass over `data` (any object with `steps_per_epoch(b)` and
        `batches(b, epoch, seed)`). Loss readbacks wait for the print
        cadence and the epoch end, so steps queue without host syncs."""
        cfg = self.cfg
        losses = AverageMeter("Loss", ":.4f")
        batch_time = AverageMeter("Time", ":6.3f")
        n_steps = data.steps_per_epoch(cfg.optim.batch_size)
        progress = ProgressMeter(n_steps, [batch_time, losses],
                                 prefix=f"Train epoch: [{epoch}]")
        step_losses, pending = [], []
        end = time.time()
        for it, batch in enumerate(
                data.batches(cfg.optim.batch_size, epoch, cfg.run.seed)):
            metrics = self.train_step(
                self._upload(batch.derm), self._upload(batch.derm_hw),
                self._upload(batch.clinic), self._upload(batch.clinic_hw),
                prng.step_seed(cfg.run.seed, epoch, it))
            pending.append((metrics["loss"], batch.derm.shape[0]))
            batch_time.update(time.time() - end)
            end = time.time()
            if it % cfg.run.print_freq == 0 and it > 0:
                common.drain_losses(pending, losses, step_losses)
                self.logger.info(progress.display(it))
        common.drain_losses(pending, losses, step_losses)
        return {"loss": losses.avg, "step_losses": step_losses}

    def fit(self, data) -> list:
        """Train up to `cfg.optim.epochs` epochs, from `start_epoch` (0
        unless resumed); returns each epoch's stats. Rank 0 writes `ckp_{epoch}.pth` every `save_freq` epochs and at the
        end, and `checkpoint.pth` every `ckpt_freq` epochs."""
        cfg = self.cfg
        history = []
        for epoch in range(self.start_epoch, cfg.optim.epochs):
            t0 = time.time()
            stat = self.train_epoch(data, epoch)
            history.append(stat)
            self.guard_loss(epoch, stat["loss"])
            self.writer.log({"loss": stat["loss"]}, epoch, "train/")
            self.logger.info(f"Epoch {epoch}: loss {stat['loss']:.4f} "
                             f"({(time.time() - t0) / 60:.2f} min)")
            self.epoch_checkpoint(epoch)
        return history
