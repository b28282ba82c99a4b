"""In-tool linear probing of a frozen SSL extractor (counterpart of
sm3x/train/linear_probe.py): 50 epochs of AdamW(ft_lr, eps 1e-5) on eight
linear heads over the concatenated features of the two encoders.

The extractor is frozen, so only its forward runs, in eval mode and without
a graph. The train transform (crop and flip) changes the features every
epoch, so they are recomputed every epoch. The heads start from the seed's
stream 3.

Under a process group each rank extracts the features of its rows of
every batch (the train views drawn for the whole batch); the train
features of all ranks are gathered, so the probe takes the same steps on
every rank, and the eval predictions come together at the epoch's end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sm3x_torch import CLASSES_NAME, CLS_WEIGHTS, NUM_CLASSES
from sm3x_torch.core import prng
from sm3x_torch.core.mesh import data_group, local_rows
from sm3x_torch.data.prefetch import to_device
from sm3x_torch.losses import weighted_multilabel_ce
from sm3x_torch.metrics import compute_stage_metrics
from sm3x_torch.models.baseline import MultiHeadClassifier
from sm3x_torch.ops.augment import (PROBE_AUG, eval_resize_batch,
                                    ssl_augment_batch)
from sm3x_torch.parallel.collectives import gather_rows
from sm3x_torch.train import common
from sm3x_torch.train.supervised import _concat_masked
from sm3x_torch.utils.misc import setup_logger


class LinearProbe:
    """Probe a frozen `extract_feats` with one linear head a label, on the
    card unless `device` says otherwise. `classes_name` / `cls_weights`
    default to the Derm7pt 8-label schema."""

    def __init__(self, feat_dim: int, ft_lr: float = 1e-3, wd: float = 5e-2,
                 num_classes=tuple(NUM_CLASSES), seed: int = 3407,
                 device="cuda", classes_name=None, cls_weights=None):
        self.device = torch.device(device)
        self.seed = seed
        self.num_classes = tuple(num_classes)
        self.classes_name = tuple(CLASSES_NAME if classes_name is None
                                  else classes_name)
        self.cls_weights = tuple(CLS_WEIGHTS if cls_weights is None
                                 else cls_weights)
        if len(self.classes_name) != len(self.num_classes):
            raise ValueError("classes_name and num_classes differ in length")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(prng.fold_in(seed, 3))
            self.model = MultiHeadClassifier(feat_dim, self.num_classes)
        self.model.to(self.device)
        self.optimizer = common.make_adamw(self.model.parameters(), ft_lr, wd,
                                           eps=1e-5)

    def train_step(self, feats: torch.Tensor, labels: torch.Tensor,
                   label_weights) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = weighted_multilabel_ce(self.model(feats), labels,
                                      label_weights)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, feats: torch.Tensor) -> list:
        return self.model(feats)

    def run(self, extract_feats, train_data, val_data, batch_size: int,
            epochs: int = 50, label_weights=(1.0,) * 8, seed: int = 3407,
            logger=None, train_aug=PROBE_AUG) -> dict:
        """`extract_feats(batch, seed, train)` -> (b, feat_dim) frozen
        features of this rank's rows of the batch (all B on one process)
        on the probe's device. Returns the best val stats. `train_aug` is
        taken and unused, as in the JAX package: `extract_feats` makes the
        views (`make_ssl_extract_fn(..., train_aug)`)."""
        logger = logger or setup_logger(None, "sm3x_torch.probe")
        rows = local_rows(batch_size)
        best = None
        for epoch in range(epochs):
            losses = []
            for it, batch in enumerate(
                    train_data.batches(batch_size, epoch, seed)):
                feats = gather_rows(extract_feats(
                    batch, prng.step_seed(self.seed, epoch, it), True),
                    data_group())
                labels = torch.from_numpy(np.ascontiguousarray(
                    batch.label)).to(self.device).long()
                losses.append(self.train_step(feats, labels,
                                              tuple(label_weights)))
            preds_all, targets_all, masks = [], [], []
            for batch in val_data.batches(batch_size, 0, seed, shuffle=False):
                preds_all.append(self.eval_step(extract_feats(batch, 0,
                                                              False)))
                targets_all.append(rows.take(batch.label))
                masks.append(rows.take(batch.mask))
            preds, targets = _concat_masked(preds_all, targets_all, masks)
            stats = compute_stage_metrics(
                preds, targets, num_classes=self.num_classes,
                cls_weights=self.cls_weights, classes_name=self.classes_name,
                probabilities=False)
            stats["loss"] = float(torch.stack(losses).mean())
            if best is None or stats["AUC_AVG"] > best["AUC_AVG"]:
                best = stats
            logger.info(f"probe epoch {epoch}: loss {stats['loss']:.4f} "
                        f"val AUC_AVG {stats['AUC_AVG']:.4f}")
        return best


def make_ssl_extract_fn(ssl_model, device, mean, std, img_sz=(224, 224),
                        train_aug=PROBE_AUG):
    """The frozen-extractor feature function over a stage-1 model: its two
    encoders in eval mode, no graph, on this rank's rows of a host batch;
    train views from the seed's streams 0 and 1 (drawn for the whole
    batch), eval views from the deterministic resize."""
    aug = dataclasses.replace(train_aug, out_size=tuple(img_sz))

    @torch.no_grad()
    def extract(batch, seed: int, train: bool) -> torch.Tensor:
        rows = local_rows(len(batch.index))
        derm, derm_hw, clinic, clinic_hw = (
            to_device(rows.take(x), device) for x in
            (batch.derm, batch.derm_hw, batch.clinic, batch.clinic_hw))
        if train:
            d = ssl_augment_batch(
                prng.generator(prng.fold_in(seed, 0), device), derm, derm_hw,
                mean, std, aug, rows)
            c = ssl_augment_batch(
                prng.generator(prng.fold_in(seed, 1), device), clinic,
                clinic_hw, mean, std, aug, rows)
        else:
            d = eval_resize_batch(derm, derm_hw, mean, std, tuple(img_sz))
            c = eval_resize_batch(clinic, clinic_hw, mean, std, tuple(img_sz))
        was_training = ssl_model.training
        ssl_model.eval()
        try:
            return torch.cat(ssl_model.extract(d, c), dim=1).float()
        finally:
            ssl_model.train(was_training)

    return extract
