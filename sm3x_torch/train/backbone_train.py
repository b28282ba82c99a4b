"""Stage-1 SSL pretraining (counterpart of sm3x/train/backbone_train.py:
`make_ssl_train_step` :30-144 and `make_trimodal_train_step` :149-190
(one function here), `SSLTrainer` :193-493).

One step, after the uint8 canvases reach the device:
  2 augmented views per modality (RRC as torch.bmm, photometric chain as
  kernel K1) -> SimCLRSkinV3/V32 with ResNet or ViT encoders (bf16 autocast
  around the encoders; a ViT with --use-checkpoint flash runs its attention
  as kernels K3f / K3b-dq / K3b-dkv) -> ssl_loss (all NT-Xent terms and
  groups as one K2 call) -> backward (K2b for the loss) -> AdamW.

Under --data-name SevenPCSwavDataset (multi-crop) each modality also gets
the local views of --size-crops / --nmb-crops (one K1 launch a resolution
and modality), each an encoder pass of its own, and the loss a `local`
term. Under --arch-version trimodal the batch's metadata codes join as a
third modality (sm3x_torch.models.trimodal): two dropout views, nine
NT-Xent terms, still one K2 call.

Under --bn-stat-freq K > 1 (EXPERIMENTAL, off-recipe) the dual-modal
trainer takes the standard step on every K-th step of an epoch and a fast
step on the others: the whole model in eval mode, so each BatchNorm
normalises with its running statistics and leaves them as they are, while
the gradient step is whole (sm3x/train/backbone_train.py's `frozen_bn`,
Flax's `train=False`). The same kernels run: K1 and K2 as in the
standard step.

Randomness: each step's seed is `prng.step_seed(seed, epoch, step)`; the
derm and clinic streams fold in 0 and 1, each view folds in its index, and
each view draws from its own `torch.Generator` on the device.

Under a process group (one process a GPU, sm3x_torch.parallel) `-b` is the
global batch: each rank augments its rows of it with the draws of the
whole batch, runs the model under DDP with the global-batch BatchNorm, and
computes its NT-Xent groups, or all of them from the gathered projections
(sm3x_torch.losses.ssl). A run on N processes is then the one-process run
up to the order of float reductions.

Under --mesh-model M > 1 the ranks form a grid of N / M data x M model
(sm3x_torch.core.mesh): the M ranks of a model group take the same rows,
and a ViT's blocks are split over them Megatron style (SSLTrainer
`split_model("vit")`, sm3x_torch.models.vit), the reference's
`_place_state`; a ResNet stays whole on every rank. Tri-modal and
multi-crop runs go through the same blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from sm3x_torch.core import prng
from sm3x_torch.data.prefetch import to_device, wrap_from_config
from sm3x_torch.core.mesh import batch_rows
from sm3x_torch.data.datasets import PAIRED as DATASETS
from sm3x_torch.losses.ssl import local_groups, ssl_loss
from sm3x_torch.models.backbones import is_vit
from sm3x_torch.models.simclr import build_ssl_model
from sm3x_torch.models.trimodal import TriModalSimCLR, trimodal_ssl_loss
from sm3x_torch.ops.augment import (SSL_AUG, modality_keys, modality_valid_hw,
                                    multicrop_augment_batch, ssl_augment_batch)
from sm3x_torch.train import common
from sm3x_torch.utils.logging import StatWriter
from sm3x_torch.utils.profiling import annotate
from sm3x_torch.utils.misc import AverageMeter, ProgressMeter, setup_logger

MULTICROP = "SevenPCSwavDataset"
NOT_PORTED = "is not ported (ROADMAP.md, \"Do not port\")"


def unsupported(cfg) -> list:
    """Settings of `cfg` outside what the port's stage 1 does yet, each with
    where it stands; an empty list when the run is within the slice."""
    m, d = cfg.model, cfg.data
    checks = [
        (d.data_name not in DATASETS,
         f"--data-name {d.data_name}: the port's stage 1 takes "
         f"{', '.join(DATASETS)} (the single-image ISIC sets go to "
         f"tools/transfer_probe_torch.py)"),
        (m.arch_version == "trimodal" and d.data_name == MULTICROP,
         "multi-crop (SevenPCSwavDataset) and --arch-version trimodal are "
         "not combinable"),
        (m.negatives not in ("local", "global"),
         f"--negatives {m.negatives}"),
    ]
    return [msg for bad, msg in checks if bad] + unsupported_run(cfg)


def unsupported_run(cfg) -> list:
    """The run settings that no stage of the port takes: the Orbax
    checkpoint backend (not ported). --mesh-data is taken and, as in the JAX
    package, the data axis is the run's processes over --mesh-model
    whatever it says; a --mesh-model that does not divide the processes is
    refused where the grid is made (sm3x_torch.core.mesh.make_mesh)."""
    r = cfg.run
    checks = [
        (r.ckpt_backend != "msgpack",
         f"--ckpt-backend {r.ckpt_backend} {NOT_PORTED}; the port writes "
         f".pth files"),
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


def augment_views(seed: int, canvases, valid_hw, mean, std, cfg,
                  rows=None):
    """Two views of one modality, each from its own generator; `rows`:
    these canvases are those rows of the global batch."""
    dev = canvases.device
    return tuple(ssl_augment_batch(prng.generator(prng.fold_in(seed, v), dev),
                                   canvases, valid_hw, mean, std, cfg, rows)
                 for v in range(2))


def _metrics(total, parts, groups: int, world: int) -> dict:
    """The loss and its parts as detached device scalars; where every rank
    holds whole groups, their mean over ranks (each rank's is its share)."""
    metrics = {"loss": total.detach(),
               **{k: v.detach() for k, v in parts.items()}}
    if world > 1 and local_groups(groups, world):
        mean = common.global_mean(torch.stack(list(metrics.values())))
        metrics = dict(zip(metrics, mean.unbind()))
    return metrics


@contextlib.contextmanager
def frozen_statistics(model, frozen: bool):
    """Inside the block, where `frozen`, every module of `model` is in eval
    mode: a BatchNorm normalises with its running statistics and moves
    none of them. Each module's own mode comes back after it, whatever
    happens. The block holds the backward too: a segment that
    --use-checkpoint recomputes there must run in the forward's mode."""
    if not frozen:
        yield
        return
    modes = [(module, module.training) for module in model.modules()]
    model.eval()
    try:
        yield
    finally:
        for module, training in modes:
            module.training = training


def _descend(optimizer, loss_fn, groups: int, world: int) -> dict:
    """Gradients cleared (before the forward, so the last step's are not
    held through it), `loss_fn()` -> (total, parts), backward and one AdamW
    step; the metrics."""
    with annotate("trainer.optimizer"):
        optimizer.zero_grad(set_to_none=True)
    total, parts = loss_fn()
    with annotate("trainer.backward"):
        total.backward()
    with annotate("trainer.optimizer"):
        optimizer.step()
    return _metrics(total, parts, groups, world)


def ssl_update(model, optimizer, derm_views, clinic_views, style: int,
               temperature: float, groups: int,
               modality_weights=(1.0, 1.0), world: int = 1, derm_locals=(),
               clinic_locals=(), local_weight: float = 1.0,
               frozen_bn: bool = False) -> dict:
    """Forward, loss, backward and AdamW step on augmented views (this
    rank's rows of them across `world` processes, `model` under DDP), and
    multi-crop local views where given; with `frozen_bn` all of it in
    eval mode (`frozen_statistics`). Returns the global loss and its
    parts as detached device scalars (read them back when needed)."""
    def loss_fn():
        with annotate("model.forward"):
            outs = model(derm_views, clinic_views, derm_locals,
                         clinic_locals)
        with annotate("loss"):
            return ssl_loss(outs, style, temperature, groups,
                            modality_weights=modality_weights, world=world,
                            local_weight=local_weight)

    with frozen_statistics(model, frozen_bn):
        return _descend(optimizer, loss_fn, groups, world)


def trimodal_update(model, optimizer, derm_views, clinic_views, meta_codes,
                    generator, temperature: float, groups: int,
                    rows=None) -> dict:
    """The tri-modal forward (the metadata's dropout views drawn from
    `generator`, for the global batch where `rows` are given), loss,
    backward and AdamW step; returns the metrics as `ssl_update` does."""
    world = 1 if rows is None else rows.world

    def loss_fn():
        with annotate("model.forward"), batch_rows(rows):
            outs = model(derm_views, clinic_views, meta_codes, generator)
        with annotate("loss"):
            return trimodal_ssl_loss(outs, temperature, groups, world=world)

    return _descend(optimizer, loss_fn, groups, world)


def multicrop_settings(multicrop: dict):
    """The SevenPCSwavDataset recipe of a `multicrop` dict (size_crops,
    nmb_crops, min_scale_crops, max_scale_crops, local_weight), checked as
    the JAX package checks it: equal list lengths and two global views."""
    sizes = tuple(multicrop["size_crops"])
    counts = tuple(multicrop["nmb_crops"])
    los = tuple(multicrop["min_scale_crops"])
    his = tuple(multicrop["max_scale_crops"])
    if not (len(sizes) == len(counts) == len(los) == len(his)):
        raise ValueError("size/nmb/min-scale/max-scale crop lists must "
                         f"have equal lengths, got {sizes}/{counts}/"
                         f"{los}/{his}")
    if counts[0] != 2:
        raise ValueError(f"crop group 0 is the two global SimCLR views; "
                         f"--nmb-crops must start with 2, got {counts}")
    return (dict(size_crops=sizes, nmb_crops=counts, min_scale_crops=los,
                 max_scale_crops=his),
            float(multicrop.get("local_weight", 1.0)))


def make_ssl_train_step(model, optimizer, style: int, temperature: float,
                        groups: int, mean, std, aug_cfg=SSL_AUG,
                        modality_weights=(1.0, 1.0), joint_aug: bool = False,
                        rows=None, multicrop=None, trimodal: bool = False,
                        frozen_bn: bool = False):
    """Returns step(derm, derm_hw, clinic, clinic_hw, seed) -> metrics, with
    the canvases (B, S, S, 3) uint8 and valid sizes (B, 2) on the device:
    the `rows` of the global batch where given (sm3x_torch.core.mesh.Rows,
    with `model` under DDP). `joint_aug` (SevenPCBaseDataset2) gives the
    derm/clinic pair the same augmentation parameters within their common
    valid region. `multicrop` (SevenPCSwavDataset: `multicrop_settings`'s
    dict) makes crop group 0 the two global views, at size_crops[0] and
    its scales, and adds every further group's local views. `trimodal`
    (a `TriModalSimCLR` model) makes it step(..., seed, meta): the batch's
    metadata codes ((B, F) integers of the global batch, on the host until
    the step uploads this rank's rows of them), whose two dropout views
    draw from the seed's stream 2. `frozen_bn` makes it the
    --bn-stat-freq fast step: the model's forward and backward in eval
    mode, its running statistics unchanged, the AdamW step whole; the
    tri-modal step does not take it. On the card the photometric chain
    and the loss always run kernels K1 and K2, so --use-pallas-augment /
    --use-pallas-ntxent change nothing here."""
    if frozen_bn and trimodal:
        raise ValueError("the --bn-stat-freq fast step is the dual-modal "
                         "step's; the tri-modal step runs in train mode")
    world = 1 if rows is None else rows.world
    local_weight, crops = 1.0, None
    if multicrop is not None:
        if trimodal:
            raise ValueError("multi-crop and the tri-modal step are not "
                             "combinable")
        crops, local_weight = multicrop_settings(multicrop)
        aug_cfg = dataclasses.replace(
            aug_cfg, out_size=(crops["size_crops"][0],) * 2,
            rrc_scale=(crops["min_scale_crops"][0],
                       crops["max_scale_crops"][0]))

    def views(seed, canvases, hw):
        if crops is None:
            return augment_views(seed, canvases, hw, mean, std, aug_cfg,
                                 rows), ()
        out = multicrop_augment_batch(seed, canvases, hw, mean, std,
                                      base_cfg=aug_cfg, rows=rows, **crops)
        return tuple(out[:2]), tuple(out[2:])

    def train_step(derm, derm_hw, clinic, clinic_hw, seed: int,
                   *meta) -> dict:
        with annotate("trainer.step"):
            kd, kc = modality_keys(prng.fold_in(seed, 0),
                                   prng.fold_in(seed, 1), joint_aug)
            d_hw, c_hw = modality_valid_hw(derm_hw, clinic_hw, joint_aug)
            with annotate("augment.views"):
                d, d_locals = views(kd, derm, d_hw)
            with annotate("augment.views"):
                c, c_locals = views(kc, clinic, c_hw)
            if not trimodal:
                return ssl_update(model, optimizer, d, c, style, temperature,
                                  groups, modality_weights, world, d_locals,
                                  c_locals, local_weight, frozen_bn)
            codes = meta[0] if rows is None else rows.take(meta[0])
            gen = prng.generator(prng.fold_in(seed, 2), derm.device)
            return trimodal_update(model, optimizer, d, c,
                                   to_device(codes, derm.device).long(), gen,
                                   temperature, groups, rows)

    return train_step


class SSLTrainer(common.CheckpointableTrainer):
    """Owns the model, the optimizer and the epoch loop on this process's
    device; its checkpoints have `export_simclr_skin`'s key layout (the
    tri-modal model's adds its metadata branch and cross projectors), from
    the model without its DDP wrapper."""

    scheduler = None

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
        self.is_trimodal = m.arch_version == "trimodal"
        self.bn_stat_freq = max(1, int(m.bn_stat_freq))
        if self.bn_stat_freq > 1 and self.is_trimodal:
            raise ValueError(
                "--bn-stat-freq applies to the dual-modal SSL step only "
                "(the trimodal step's dropout views need train-mode "
                "forward)")
        # initialise from the seed on the CPU, whatever the device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(prng.fold_in(cfg.run.seed, 0))
            if self.is_trimodal:
                self.model = TriModalSimCLR(
                    m.arch, m.proj_dim, tuple(m.meta_vocab_sizes),
                    amp=cfg.optim.amp, remat=self.remat,
                    img_size=tuple(cfg.data.img_sz))
                self.style = 0
            else:
                self.model, self.style = build_ssl_model(
                    m.arch_version, m.arch, m.proj_dim, amp=cfg.optim.amp,
                    remat=self.remat, img_size=tuple(cfg.data.img_sz))
        if m.arch_weights:
            self._load_arch_weights(str(m.arch_weights), m.arch)
        self.model.to(self.device)
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        self.model.train()
        self.rows = common.data_axis(cfg, self.logger)
        if is_vit(m.arch):
            self.split_model("vit")
        world = self.rows.world
        # per-device-negatives parity: world_size groups, by default one a
        # process (sm3x/train/backbone_train.py:249-253)
        self.groups = 1 if m.negatives == "global" else (
            cfg.run.world_size or world)
        self.optimizer = common.make_adamw(
            self.model.parameters(), cfg.optim.base_lr, cfg.optim.wd,
            eps=cfg.optim.adam_eps)
        aug_cfg = dataclasses.replace(SSL_AUG, out_size=tuple(cfg.data.img_sz))
        self.net = common.data_parallel(self.model, self.device)
        joint_aug = cfg.data.data_name == "SevenPCBaseDataset2"
        if self.is_trimodal:
            self.logger.info(f"trimodal SSL: metadata vocab sizes "
                             f"{tuple(m.meta_vocab_sizes)}")
        multicrop = None
        if cfg.data.data_name == MULTICROP:
            d = cfg.data
            multicrop = dict(size_crops=d.size_crops, nmb_crops=d.nmb_crops,
                             min_scale_crops=d.min_scale_crops,
                             max_scale_crops=d.max_scale_crops,
                             local_weight=m.local_loss_weight)
            self.logger.info(
                f"multi-crop SSL: sizes {d.size_crops}, counts "
                f"{d.nmb_crops}, local weight {m.local_loss_weight}")
        step_args = (self.net, self.optimizer, self.style, m.temperature,
                     self.groups, tuple(cfg.data.mean), tuple(cfg.data.std),
                     aug_cfg)
        step_kw = dict(modality_weights=tuple(cfg.modality_weights),
                       joint_aug=joint_aug, rows=self.rows,
                       multicrop=multicrop)
        self.train_step = make_ssl_train_step(
            *step_args, trimodal=self.is_trimodal, **step_kw)
        # --bn-stat-freq K > 1 (off-recipe): every K-th step refreshes the
        # BatchNorm statistics; the others take the eval-mode fast step
        self.fast_step = None
        if self.bn_stat_freq > 1:
            self.fast_step = make_ssl_train_step(*step_args, frozen_bn=True,
                                                 **step_kw)
            k = self.bn_stat_freq
            self.logger.info(
                f"bn-stat-freq {k}: BN statistics refresh every {k} steps "
                f"(EXPERIMENTAL, off-recipe; running stats lag up to "
                f"{k - 1} steps — measured harmful to feature quality in a "
                f"learning-regime grid, BENCH.md round 4)")

    def _load_arch_weights(self, value: str, arch: str) -> None:
        """--arch-weights: both encoders start from a torchvision-layout
        ResNet state dict, a `.pth` path or an enum name ('IMAGENET1K_V1',
        the reference's run.sh syntax) resolved against staged local files
        with a sha256 check (sm3x_torch.utils.weight_registry). The port's
        ResNet has torchvision's keys, so the load is strict and converts
        nothing; the classifier's `fc.*` keys are dropped."""
        from sm3x_torch.utils.checkpoint import load_state_dict_file
        from sm3x_torch.utils.weight_registry import resolve_arch_weights

        path = resolve_arch_weights(value, arch)
        state = {k: v for k, v in load_state_dict_file(path).items()
                 if not k.startswith("fc.")}
        for branch in (self.model.derm_backbone, self.model.clinic_backbone):
            branch.encoder.load_state_dict(state, strict=True)
        self.logger.info(f"initialized encoders from '{path}' "
                         f"(--arch-weights {value})")

    def _apply_lr_schedule(self, steps_per_epoch: int) -> None:
        """--use-lr-schedule: warm-up and cosine over the whole run, stepped
        every iteration. Fresh runs only: the schedule's count starts at 0,
        so a resumed run is refused."""
        o = self.cfg.optim
        if self.start_epoch > 0:
            raise ValueError(
                "--use-lr-schedule cannot resume mid-run: the schedule "
                "count restarts at 0; rerun from scratch or drop the flag")
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, common.warmup_cosine_factor(
                o.base_lr, o.final_lr, o.warmup_epochs, o.epochs,
                steps_per_epoch, o.start_warmup))
        self.logger.info(
            f"lr schedule: warmup {o.warmup_epochs} epochs "
            f"({o.start_warmup} -> {o.base_lr}), cosine to {o.final_lr} "
            f"over {o.epochs} epochs x {steps_per_epoch} steps")

    def _upload(self, x) -> torch.Tensor:
        return to_device(x, self.device)

    def _meta(self, batch) -> tuple:
        """The tri-modal step's last argument: the batch's metadata codes,
        left on the host (the step uploads its rows of them)."""
        if not self.is_trimodal:
            return ()
        if batch.meta is None:
            raise ValueError(
                "--arch-version trimodal needs a dataset with metadata codes "
                "(Derm7pt SevenPCBaseDataset provides them); this batch has "
                "none")
        return (batch.meta,)

    def train_epoch(self, data, epoch: int) -> dict:
        """One pass over `data` (any object with `steps_per_epoch(b)` and
        `batches(b, epoch, seed)`). Under --bn-stat-freq K the steps whose
        index in the epoch is not a multiple of K take the fast step. Loss
        readbacks wait for the print cadence and the epoch end, so steps
        queue without host syncs."""
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
            step = self.train_step
            if self.fast_step is not None and it % self.bn_stat_freq:
                step = self.fast_step
            metrics = step(
                self._upload(batch.derm), self._upload(batch.derm_hw),
                self._upload(batch.clinic), self._upload(batch.clinic_hw),
                prng.step_seed(cfg.run.seed, epoch, it), *self._meta(batch))
            if self.scheduler is not None:
                self.scheduler.step()
            pending.append((metrics["loss"], len(batch.index)))
            batch_time.update(time.time() - end)
            end = time.time()
            if it % cfg.run.print_freq == 0 and it > 0:
                common.drain_losses(pending, losses, step_losses)
                self.logger.info(progress.display(it))
        common.drain_losses(pending, losses, step_losses)
        return {"loss": losses.avg, "step_losses": step_losses}

    def fit(self, data) -> list:
        """Train up to `cfg.optim.epochs` epochs, from `start_epoch` (0
        unless resumed); returns each epoch's stats. The data goes through
        the feed that --device-feed names (sm3x_torch.data.prefetch). Rank 0
        writes `ckp_{epoch}.pth` every `save_freq` epochs and at the end,
        and `checkpoint.pth` every `ckpt_freq` epochs, off the loop's
        thread; every file is whole when this returns."""
        cfg = self.cfg
        data = wrap_from_config(data, self.device, cfg.data)
        self.install_preemption_handler()
        if cfg.optim.use_lr_schedule:
            self._apply_lr_schedule(data.steps_per_epoch(cfg.optim.batch_size))
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
