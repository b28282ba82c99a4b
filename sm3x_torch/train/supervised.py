"""Supervised train / eval loops shared by mlc_eval, backbone_eval and the
in-tool linear probe (counterpart of sm3x/train/supervised.py).

A train step: one augmented view a modality (RRC as torch.bmm, crop, flip
and normalise as kernel K1 on the card) -> forward -> per-label weighted
cross-entropy -> backward -> AdamW over the trainable tensors. An eval
step: deterministic resize -> forward, without a graph. The epoch's metrics
run on the host over the collected logits, with wrap-padded rows masked
out.

Under a process group each rank runs its rows of every global batch (the
views' draws made for the whole batch, the model under DDP); the epoch's
predictions, targets and masks come to every rank in one gather, so the
metrics are those of the whole split, the same on every rank, and rank 0
writes `results.csv` and `best_eval.pth`.

Nothing in a step loop reads the device back: losses and predictions stay
device tensors until the last step is queued, then come over in one
`torch.cat` and one transfer.

Randomness: a step's seed is `prng.step_seed(seed, epoch, step)` and folds
in 0, 1 and 2 for the derm view, the clinic view and dropout, as stage 2's
step does.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Sequence

import numpy as np
import torch

from sm3x_torch import CLASSES_NAME, METRICS_NAME
from sm3x_torch.core import prng
from sm3x_torch.data.prefetch import (resident_nbytes, to_device,
                                      wrap_from_config)
from sm3x_torch.core.mesh import batch_rows, data_group
from sm3x_torch.losses import weighted_multilabel_ce
from sm3x_torch.metrics import (compute_stage_metrics,
                                mean_average_precision, write_results_csv)
from sm3x_torch.ops.augment import eval_resize_batch
from sm3x_torch.parallel.collectives import host_gather_tree
from sm3x_torch.train import common
from sm3x_torch.train.backbone_train import DATASETS, unsupported_run
from sm3x_torch.train.mlc_train import augment_pair
from sm3x_torch.utils.logging import generate_stat_text
from sm3x_torch.utils.misc import (AverageMeter, BestRecorder,
                                   create_eval_stat)


def unsupported(cfg) -> list:
    """Settings of `cfg` outside what the port's eval stages do yet, each
    with where it stands; an empty list when the run is within the slice."""
    d = cfg.data
    checks = [
        (d.data_name not in DATASETS,
         f"--data-name {d.data_name}: the port's eval stages take "
         f"{' or '.join(DATASETS)}"),
    ]
    return [msg for bad, msg in checks if bad] + unsupported_run(cfg)


def supervised_update(forward_train: Callable, optimizer, derm_view,
                      clinic_view, labels: torch.Tensor, label_weights,
                      generator=None, rows=None):
    """Forward, the weighted multi-label cross-entropy, backward and the
    optimizer step on given views (`rows` of the global batch where
    given). `forward_train(d, c, generator)` returns the list of logits;
    `labels` is (B, num_labels) integer. Returns the detached loss (this
    rank's) and predictions, on the device."""
    optimizer.zero_grad(set_to_none=True)
    with batch_rows(rows):
        preds = forward_train(derm_view, clinic_view, generator)
    loss = weighted_multilabel_ce(preds, labels, label_weights)
    loss.backward()
    optimizer.step()
    return loss.detach(), [p.detach() for p in preds]


def make_supervised_steps(forward_train: Callable, forward_eval: Callable,
                          optimizer, label_weights: Sequence[float], mean,
                          std, train_aug, eval_size=(224, 224),
                          joint_aug: bool = False, rows=None):
    """Returns (train_step, eval_step):
      train_step(derm, derm_hw, clinic, clinic_hw, labels, seed)
          -> (loss, preds), detached device tensors;
      eval_step(derm, derm_hw, clinic, clinic_hw) -> preds.
    The canvases are (B, S, S, 3) uint8 and the valid sizes (B, 2) on the
    device (`rows` of the global batch where given, with their labels);
    `forward_eval(d, c)` returns the logits in eval mode."""
    label_weights = tuple(float(w) for w in label_weights)

    def train_step(derm, derm_hw, clinic, clinic_hw, labels, seed: int):
        d, c = augment_pair(seed, derm, derm_hw, clinic, clinic_hw, mean, std,
                            train_aug, joint_aug, rows)
        drop = prng.generator(prng.fold_in(seed, 2), derm.device)
        return supervised_update(forward_train, optimizer, d, c, labels,
                                 label_weights, drop, rows)

    @torch.no_grad()
    def eval_step(derm, derm_hw, clinic, clinic_hw):
        d = eval_resize_batch(derm, derm_hw, mean, std, eval_size)
        c = eval_resize_batch(clinic, clinic_hw, mean, std, eval_size)
        return forward_eval(d, c)

    return train_step, eval_step


@contextlib.contextmanager
def full_float32(*autocast_modules):
    """Float32 arithmetic for the block: the bf16 autocast of each module
    (its `amp` flag) off, and TF32 off for products and convolutions."""
    flags = [m.amp for m in autocast_modules]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    for m in autocast_modules:
        m.amp = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        for m, flag in zip(autocast_modules, flags):
            m.amp = flag
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def upload_batch(batch, device) -> tuple:
    """(derm, derm_hw, clinic, clinic_hw) of a batch on `device`: uploaded
    now from a host batch, taken as they are where a feed put them there."""
    return tuple(to_device(x, device)
                 for x in (batch.derm, batch.derm_hw, batch.clinic,
                           batch.clinic_hw))


def run_train_epoch(trainer, data, epoch: int) -> dict:
    """One pass of `trainer.train_step` over `data` (this rank's rows of
    each batch, `trainer.rows`); the epoch's metrics over the predictions
    of all ranks, and the mean loss of the global batches."""
    cfg = trainer.cfg
    rows = trainer.rows
    losses = AverageMeter("Loss", ":.4f")
    all_preds, all_targets, all_masks, pending = [], [], [], []
    for it, batch in enumerate(
            data.batches(cfg.optim.batch_size, epoch, cfg.run.seed)):
        label = rows.take(batch.label)
        labels = torch.from_numpy(
            np.ascontiguousarray(label)).to(trainer.device).long()
        loss, preds = trainer.train_step(
            *upload_batch(batch, trainer.device), labels,
            prng.step_seed(cfg.run.seed, epoch, it))
        # every read-back waits for the last step: a float() a step would
        # stall the queue on a round trip to the device
        pending.append(loss)
        all_preds.append(preds)
        all_targets.append(label)
        all_masks.append(rows.take(batch.mask))
    if pending:
        # the ranks' losses of each step in one all-reduce
        for loss in common.global_mean(torch.stack(pending)).tolist():
            losses.update(loss, rows.total)
    stats = _epoch_metrics(all_preds, all_targets, all_masks)
    stats["loss"] = losses.avg
    return stats


def _eval_pass(trainer, data):
    """`trainer.eval_step` over the whole split in order (`epoch=0,
    shuffle=False`): per-step predictions on the device, targets, masks,
    each of this rank's rows."""
    cfg = trainer.cfg
    rows = trainer.rows
    all_preds, all_targets, all_masks = [], [], []
    for batch in data.batches(cfg.optim.batch_size, epoch=0,
                              seed=cfg.run.seed, shuffle=False):
        all_preds.append(trainer.eval_step(
            *upload_batch(batch, trainer.device)))
        all_targets.append(rows.take(batch.label))
        all_masks.append(rows.take(batch.mask))
    return all_preds, all_targets, all_masks


def run_eval_epoch(trainer, data, epoch: int = 0) -> dict:
    return _epoch_metrics(*_eval_pass(trainer, data))


def collect_eval_logits(trainer, data):
    """(preds_list, targets) over the full split, padding removed: what
    `sm3x_torch.metrics.results_table` takes for the CSV."""
    return _concat_masked(*_eval_pass(trainer, data))


def _concat_masked(all_preds, all_targets, all_masks):
    """Per-step lists of per-label logits (device tensors), targets and
    masks of this rank's rows -> one array a label on the host for the
    whole of every batch, rows of wrap-padding dropped: one `torch.cat`,
    one transfer and, under a process group, one gather over the data
    group for the epoch (the ranks' rows of each step side by side, the
    order of one process)."""
    widths = [p.shape[1] for p in all_preds[0]]
    flat = torch.stack([torch.cat([p.float() for p in step], dim=1)
                        for step in all_preds])
    got = host_gather_tree({"preds": flat, "targets": np.stack(all_targets),
                            "mask": np.stack(all_masks)}, axis=1,
                           group=data_group())
    mask = got["mask"].reshape(-1)
    flat = got["preds"].reshape(-1, flat.shape[-1])
    edges = np.cumsum([0] + widths)
    preds = [flat[mask, a:b] for a, b in zip(edges[:-1], edges[1:])]
    targets = got["targets"].reshape(mask.shape[0], -1)[mask]
    return preds, targets


def _epoch_metrics(all_preds, all_targets, all_masks) -> dict:
    preds, targets = _concat_masked(all_preds, all_targets, all_masks)
    # the loops hold raw logits: say so, and leave nothing to the [0, 1]
    # heuristic, which misreads early-training logits
    stats = compute_stage_metrics(preds, targets, probabilities=False)
    stats.update(mean_average_precision(preds, targets, probabilities=False))
    return stats


class SupervisedTrainer(common.CheckpointableTrainer):
    """The epoch loop the two eval trainers share: a train pass and an eval
    pass an epoch, the best model by val AUC_AVG stashed on the device and
    written once after the loop, `results.csv` from a float32 eval pass.
    A trainer sets `cfg`, `device`, `logger`, `writer`, `model`,
    `optimizer`, `train_step`, `eval_step`, `autocast_modules` and `rows`
    (this rank's rows of each global batch, `common.data_axis`)."""

    best_auc: float = 0.0
    per_label_summary = False

    def extra_state(self) -> dict:
        return {"best_val_auc": self.best_auc}

    def restore_extra_state(self, ckpt: dict) -> None:
        self.best_auc = float(ckpt.get("best_val_auc", 0.0))

    def fit(self, train_data, val_data) -> float:
        """Train up to `cfg.optim.epochs` epochs from `start_epoch`;
        returns the best val AUC_AVG. Both splits go through the feed that
        --device-feed names, under one memory budget: the validation split
        is charged what the training split pinned."""
        cfg = self.cfg
        self.warn_unconsumed_lr_schedule()
        train_data = wrap_from_config(train_data, self.device, cfg.data)
        val_data = wrap_from_config(
            val_data, self.device, cfg.data,
            reserved_bytes=resident_nbytes(train_data))
        self.install_preemption_handler()
        summary = {}
        if self.per_label_summary:
            for prefix in ("train", "val"):
                summary.update(create_eval_stat(prefix, METRICS_NAME,
                                                CLASSES_NAME, "max"))
            summary.update({"train/loss": "min", "val/loss": "min"})
            summary = {k: BestRecorder(v) for k, v in summary.items()}
        best_auc = self.best_auc
        for epoch in range(self.start_epoch, cfg.optim.epochs):
            t0 = time.time()
            tr = run_train_epoch(self, train_data, epoch)
            self.guard_loss(epoch, tr["loss"])
            va = run_eval_epoch(self, val_data, epoch)
            self.writer.log(tr, epoch, "train/")
            self.writer.log(va, epoch, "val/")
            for prefix, stat in (("train", tr), ("val", va)):
                for k, v in stat.items():
                    if f"{prefix}/{k}" in summary:
                        summary[f"{prefix}/{k}"].update(v)
            if va["AUC_AVG"] > best_auc:
                best_auc = self.best_auc = va["AUC_AVG"]
                self.stash_best(epoch, best_auc)
            self.epoch_checkpoint(epoch)
            self.logger.info(
                f"Epoch {epoch}: train loss {tr['loss']:.4f}, "
                f"val AUC_AVG {va['AUC_AVG']:.4f} (best {best_auc:.4f}) "
                f"({(time.time() - t0) / 60:.2f} min)")
            if summary:
                self.logger.debug(
                    "--------------------- Summary Statistics "
                    "----------------\n" + generate_stat_text(
                        tr, va, summary, METRICS_NAME, CLASSES_NAME))
            if self.preemption_break(epoch):
                break
        self.write_best()
        self.finish_checkpoints()
        return best_auc

    def write_results(self, data, path: str) -> str:
        """`results.csv` in the released layout from an eval pass in
        float32 (TF32 off), whatever --amp says: two bf16 programs differ
        beyond the CSV's tolerance. `data` goes through the feed that
        --device-feed names (already wrapped, it passes through); every
        rank runs the pass, rank 0 writes the file."""
        data = wrap_from_config(data, self.device, self.cfg.data)
        with full_float32(*self.autocast_modules):
            preds, targets = collect_eval_logits(self, data)
        if not common.is_main_process():
            return path
        return write_results_csv(path, preds, targets, probabilities=False)
