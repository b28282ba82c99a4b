"""Stage-2 DeepCluster MLC training (counterpart of
sm3x/train/mlc_train.py: `make_mlc_train_step` :39, `make_embed_step` :80,
`cluster_and_update` :103, `MLCTrainer` :131).

The loop: one no-gradient pass over the data fills the memory bank with
the label tokens `sa` of every case; then every epoch clusters each label's
bank rows with spherical k-means, writes the centroids into that label's
prototype weights and takes the assignments as the epoch's targets; every
step makes one augmented view a modality (RRC as torch.bmm, the
photometric chain as kernel K1 on the card), runs the frozen dual
extractor and the head, takes the mean cluster cross-entropy of the eight
labels, steps AdamW on the head and overwrites the batch's bank rows.

The bank is one (heads, N, proj_dim) float32 tensor on the device, written
in place. The init pass runs the extractor in train mode, as the reference
does: it normalises with batch statistics and moves the frozen encoders'
running statistics; the train step runs it in eval mode unless
--finetune-backbone. Dropout is on in both.

Randomness: a step's seed is `prng.step_seed(seed, epoch, step)` and folds
in 0, 1 and 2 for the derm view, the clinic view and dropout, each with
its own `torch.Generator`; the init pass starts from `fold_in(seed, 999)`;
k-means folds in the epoch, its stream's number and the label's index.

Under a process group each rank holds its rows of every global batch:
views and dropout masks are drawn for the whole batch and cut to them, the
head trains under DDP, and the rows `sa` of all ranks are gathered and
written into every rank's bank at the batch's global index. k-means runs
on every rank from the same bank and the same generator, so the
assignments are the same bits everywhere.

Under --mesh-model M > 1 the label heads are split over the model axis
(`split_model("labels")`, sm3x_torch.models.projector): the M ranks of a
model group take the same rows, each runs its L / M heads, and the heads'
tokens are gathered along the heads before the transformer layer, which,
like the extractor and the prototypes, every rank holds whole. The rows
of the bank are gathered over the data group only, so a batch writes B
rows, not M B.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from sm3x_torch.core import prng
from sm3x_torch.core.mesh import batch_rows, data_group
from sm3x_torch.data.prefetch import to_device, wrap_from_config
from sm3x_torch.losses import cluster_ce
from sm3x_torch.models.mlc import MLCModel
from sm3x_torch.ops.augment import (MLC_TRAIN_AUG, modality_keys,
                                    modality_valid_hw, ssl_augment_batch)
from sm3x_torch.ops.kmeans import spherical_kmeans
from sm3x_torch.parallel.collectives import gather_rows, group_info
from sm3x_torch.train import common
from sm3x_torch.utils.logging import StatWriter
from sm3x_torch.train.backbone_train import DATASETS, unsupported_run
# a stage-1 file's two encoders; kept importable under its first name
from sm3x_torch.utils.checkpoint import (  # noqa: F401
    load_encoder_state as load_extractor_state)
from sm3x_torch.utils.misc import AverageMeter, ProgressMeter, setup_logger

INIT_STREAM, KMEANS_STREAM = 999, 1000


def unsupported(cfg) -> list:
    """Settings of `cfg` outside what the port's stage 2 does yet, each with
    where it stands; an empty list when the run is within the slice."""
    d = cfg.data
    checks = [
        (d.data_name not in DATASETS,
         f"--data-name {d.data_name}: the port's stage 2 takes "
         f"{' or '.join(DATASETS)}"),
    ]
    return [msg for bad, msg in checks if bad] + unsupported_run(cfg)


def augment_pair(seed: int, derm, derm_hw, clinic, clinic_hw, mean, std,
                 aug_cfg, joint_aug: bool, rows=None):
    """One augmented view a modality, from the seed's streams 0 and 1;
    `rows`: these canvases are those rows of the global batch."""
    kd, kc = modality_keys(prng.fold_in(seed, 0), prng.fold_in(seed, 1),
                           joint_aug)
    d_hw, c_hw = modality_valid_hw(derm_hw, clinic_hw, joint_aug)
    dev = derm.device
    d = ssl_augment_batch(prng.generator(kd, dev), derm, d_hw, mean, std,
                          aug_cfg, rows)
    c = ssl_augment_batch(prng.generator(kc, dev), clinic, c_hw, mean, std,
                          aug_cfg, rows)
    return d, c


def gather_tokens(sa: torch.Tensor) -> torch.Tensor:
    """(heads, b, P) of this rank's rows -> (heads, B, P) of the global
    batch, in one gather over the data group (`sa` itself where that is
    one rank)."""
    group = data_group()
    if group_info(group)[1] == 1:
        return sa
    return gather_rows(sa.transpose(0, 1).contiguous(),
                       group).transpose(0, 1)


def mlc_update(model, optimizer, bank, derm_view, clinic_view, index,
               assignments, temperature: float,
               finetune_backbone: bool = False,
               generator=None, rows=None) -> torch.Tensor:
    """Forward, the mean cluster cross-entropy over the labels, backward,
    the AdamW step and the bank write, on given views. `index` (B,) are the
    global batch's rows of the bank, `assignments` (labels, N) the epoch's
    targets, and the views `rows` of the batch where given (`model` under
    DDP). Returns the detached global loss on the device."""
    optimizer.zero_grad(set_to_none=True)
    with batch_rows(rows):
        sa, preds = model(derm_view, clinic_view,
                          extractor_train=finetune_backbone, head_train=True,
                          stop_extractor_grad=not finetune_backbone,
                          generator=generator)
    mine = index if rows is None else rows.take(index)
    loss = torch.stack([
        cluster_ce(pred, assignments[i, mine], temperature)
        for i, pred in enumerate(preds)]).mean()
    loss.backward()
    optimizer.step()
    bank[:, index] = gather_tokens(sa.detach())   # the batch's slots
    return common.global_mean(loss)


def make_mlc_train_step(model, optimizer, temperature: float, mean, std,
                        aug_cfg, finetune_backbone: bool,
                        joint_aug: bool = False, rows=None):
    """Returns step(bank, derm, derm_hw, clinic, clinic_hw, index,
    assignments, seed) -> loss, with the canvases (B, S, S, 3) uint8, the
    valid sizes (B, 2) on the device, `rows` of the global batch where
    given, and the global batch's index (B,) int64."""

    def train_step(bank, derm, derm_hw, clinic, clinic_hw, index,
                   assignments, seed: int) -> torch.Tensor:
        d, c = augment_pair(seed, derm, derm_hw, clinic, clinic_hw, mean, std,
                            aug_cfg, joint_aug, rows)
        drop = prng.generator(prng.fold_in(seed, 2), derm.device)
        return mlc_update(model, optimizer, bank, d, c, index, assignments,
                          temperature, finetune_backbone, drop, rows)

    return train_step


def make_embed_step(model, mean, std, aug_cfg, joint_aug: bool = False,
                    rows=None):
    """The init-memory pass of one batch: every module in train mode (the
    reference never switches to eval before it), no gradient. Returns
    embed(derm, derm_hw, clinic, clinic_hw, seed) -> sa (heads, B, P) of
    the global batch (gathered from every rank); the batch-norm running
    statistics move as a side effect."""

    @torch.no_grad()
    def embed(derm, derm_hw, clinic, clinic_hw, seed: int) -> torch.Tensor:
        d, c = augment_pair(seed, derm, derm_hw, clinic, clinic_hw, mean, std,
                            aug_cfg, joint_aug, rows)
        drop = prng.generator(prng.fold_in(seed, 2), derm.device)
        with batch_rows(rows):
            sa, _ = model(d, c, extractor_train=True, head_train=True,
                          stop_extractor_grad=True, generator=drop)
        return gather_tokens(sa)

    return embed


@torch.no_grad()
def cluster_and_update(seed: int, bank: torch.Tensor, model,
                       num_classes, iters: int = 10,
                       init_idx=None) -> torch.Tensor:
    """Spherical k-means a label, on `bank[i % heads]` with
    `num_classes[i]` clusters; the centroids are copied into
    `model.prototypes[i].weight` and the assignments come back as
    (labels, N) int64. `init_idx[i]`, where given, are the label's initial
    rows; else they are drawn from `fold_in(seed, i)`."""
    n_heads = bank.shape[0]
    assignments = []
    for i, k in enumerate(num_classes):
        centroids, a = spherical_kmeans(
            bank[i % n_heads], k, iters,
            init_idx=None if init_idx is None else init_idx[i],
            generator=prng.generator(prng.fold_in(seed, i), bank.device))
        weight = model.prototypes[i].weight
        weight.copy_(centroids.to(weight.dtype))
        assignments.append(a)
    return torch.stack(assignments)


class MLCTrainer(common.CheckpointableTrainer):
    """Owns the model, the optimizer, the memory bank and the DeepCluster
    loop on this process's device; its checkpoints have
    `export_mlc_model`'s key layout, which the eval stage reads."""

    def __init__(self, cfg, logger=None, extractor_state=None):
        problems = unsupported(cfg)
        if problems:
            raise ValueError("; ".join(problems))
        self.cfg = cfg
        self.device = torch.device(cfg.run.device)
        self.logger = logger or setup_logger(cfg.run.log_path,
                                             "sm3x_torch.mlc")
        self.writer = StatWriter(cfg.run.log_path, cfg.run.tensorboard,
                                 cfg.run.wandb, cfg.run.proj_name,
                                 logger=self.logger)
        m = cfg.model
        # initialise from the seed on the CPU, whatever the device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(prng.fold_in(cfg.run.seed, 0))
            self.model = MLCModel(
                arch=m.arch, proj_dim=m.mlc_proj_dim, num_labels=m.num_labels,
                mlc_proj=m.mlc_proj, l2_norm=m.l2_norm, n_heads=m.num_heads,
                sa_dim_ff=m.sa_dim_ff, sa_dropout=m.sa_dropout,
                use_prototype_bias=False, num_classes=tuple(m.num_classes),
                amp=cfg.optim.amp, img_size=tuple(cfg.data.img_sz))
        if extractor_state is not None:
            self.model.extractor.load_state_dict(extractor_state, strict=True)
        self.model.to(self.device)
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        self.rows = common.data_axis(cfg, self.logger)
        self.split_model("labels", num_labels=m.num_labels)
        params = common.trainable_parameters(
            self.model, lambda name: common.mlc_train_trainable(
                name, m.finetune_backbone))
        # after the freeze: DDP takes the tensors that train
        self.net = common.data_parallel(self.model, self.device)
        self.optimizer = common.make_adamw(params, cfg.optim.base_lr,
                                           cfg.optim.wd)
        aug_cfg = dataclasses.replace(MLC_TRAIN_AUG,
                                      out_size=tuple(cfg.data.img_sz))
        mean, std = tuple(cfg.data.mean), tuple(cfg.data.std)
        joint_aug = cfg.data.data_name == "SevenPCBaseDataset2"
        self.train_step = make_mlc_train_step(
            self.net, self.optimizer, m.temperature, mean, std, aug_cfg,
            m.finetune_backbone, joint_aug, self.rows)
        self.embed_step = make_embed_step(self.model, mean, std, aug_cfg,
                                          joint_aug, self.rows)
        self.bank = None
        self.assignments = None

    def extra_state(self) -> dict:
        """The memory bank goes into every checkpoint, so a resumed run
        clusters from the rows the run before it left and skips the init
        pass."""
        return {} if self.bank is None else {"bank": self.bank}

    def restore_extra_state(self, ckpt: dict) -> None:
        if "bank" in ckpt:
            self.bank = ckpt["bank"].to(self.device)

    def _upload(self, x) -> torch.Tensor:
        return to_device(x, self.device)

    def _upload_batch(self, batch):
        return (self._upload(batch.derm), self._upload(batch.derm_hw),
                self._upload(batch.clinic), self._upload(batch.clinic_hw))

    def init_memory(self, data) -> None:
        """Fill the bank with one no-gradient pass in the data's epoch-0
        order."""
        cfg = self.cfg
        self.bank = torch.zeros(cfg.model.num_labels, data.n,
                                cfg.model.mlc_proj_dim, device=self.device)
        root = prng.fold_in(cfg.run.seed, INIT_STREAM)
        for it, batch in enumerate(
                data.batches(cfg.optim.batch_size, 0, cfg.run.seed)):
            sa = self.embed_step(*self._upload_batch(batch),
                                 prng.step_seed(root, 0, it))
            self.bank[:, self._upload(batch.index).long()] = sa
        self.logger.info("Initializion of the memory banks done.")

    def cluster(self, epoch: int) -> None:
        """The epoch-boundary clustering: new prototype weights and
        targets from the bank as it stands."""
        cfg = self.cfg
        seed = prng.fold_in(prng.fold_in(cfg.run.seed, epoch), KMEANS_STREAM)
        self.assignments = cluster_and_update(
            seed, self.bank, self.model, tuple(cfg.model.num_classes),
            cfg.kmeans_iters)
        self.logger.info(f"Clustering for epoch {epoch} done.")

    def train_epoch(self, data, epoch: int) -> dict:
        """Cluster, then one pass over `data`. Loss readbacks wait for the
        print cadence and the epoch end, so steps queue without host
        syncs."""
        cfg = self.cfg
        self.cluster(epoch)
        losses = AverageMeter("Loss", ":.4f")
        n_steps = data.steps_per_epoch(cfg.optim.batch_size)
        progress = ProgressMeter(n_steps, [losses],
                                 prefix=f"Train epoch: [{epoch}]")
        step_losses, pending = [], []
        for it, batch in enumerate(
                data.batches(cfg.optim.batch_size, epoch, cfg.run.seed)):
            loss = self.train_step(
                self.bank, *self._upload_batch(batch),
                self._upload(batch.index).long(), self.assignments,
                prng.step_seed(cfg.run.seed, epoch, it))
            pending.append((loss, len(batch.index)))
            if it % cfg.run.print_freq == 0 and it > 0:
                common.drain_losses(pending, losses, step_losses)
                self.logger.info(progress.display(it))
        common.drain_losses(pending, losses, step_losses)
        return {"loss": losses.avg, "step_losses": step_losses}

    def fit(self, data) -> list:
        """Fill the bank if it is empty (a resumed run brings its own),
        then train up to `cfg.optim.epochs` epochs from `start_epoch`;
        returns each epoch's stats. The init pass and the epochs read the
        data through the feed that --device-feed names. Rank 0 writes
        `ckp_{epoch}.pth` every `save_freq` epochs and at the end, and
        `checkpoint.pth` every `ckpt_freq` epochs, off the loop's thread;
        every file is whole when this returns."""
        cfg = self.cfg
        self.warn_unconsumed_lr_schedule()
        data = wrap_from_config(data, self.device, cfg.data)
        self.install_preemption_handler()
        if self.bank is None:
            self.init_memory(data)
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
            if self.preemption_break(epoch):
                break
        self.finish_checkpoints()
        return history
