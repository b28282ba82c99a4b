"""Synthetic data for runs without the Derm7pt images (counterpart of
sm3x/data/synthetic.py, made with numpy, pandas and OpenCV alone).

`make_fake_derm7pt` writes a dataset tree in the release's on-disk layout
(meta.csv, the three index CSVs, images/); `render_label_texture` draws the
label-correlated images of its `structured=True` trees and of
tools/demo_synthetic_e2e_torch.py. Both make the same numpy random calls
in the same order as the JAX package's functions, so one seed writes the
same tree byte for byte.

`synthetic_canvas_batch` draws the same canvases, valid sizes and labels as
the JAX package's function for the same arguments. `SyntheticPairedData`
pairs two such draws (derm from `seed`, clinic from `seed + 1`; the labels
are the derm draw's) behind the interface the trainers read from a dataset
(`n`, `steps_per_epoch`, `batches`; sm3x_torch/data/pipeline.py): batches
of a fixed size with labels, the last one padded by wrapping and masked,
in a per-epoch permutation or, with `shuffle=False`, in order.
`synthetic_paired_data` gives the same canvases, labels and epoch orders as
a `PairedImageData`, which the device feeds (sm3x_torch.data.prefetch) take
like a decoded split. Both carry metadata codes for the tri-modal model,
uniform over `META_VOCAB_SIZES` (Derm7pt's elevation, sex and location, as
the config's default) from a stream of their own, so the canvases and
labels do not depend on them.
"""

from __future__ import annotations

import os

import numpy as np

from sm3x_torch.data.derm7pt import GROUPED_SCHEMA, LABEL_ORD
from sm3x_torch.data.pipeline import (Batch, PairedImageData,
                                      iter_batch_selections)

PairedBatch = Batch  # the batches' type, under its first name
META_VOCAB_SIZES = (4, 4, 16)


def synthetic_meta_codes(n: int, seed: int = 0,
                         vocab_sizes=META_VOCAB_SIZES) -> np.ndarray:
    """(n, F) int32 codes, field f uniform over [0, vocab_sizes[f])."""
    rng = np.random.default_rng([seed, 2])
    return np.stack([rng.integers(0, v, n) for v in vocab_sizes],
                    axis=1).astype(np.int32)


def render_label_texture(rng: np.random.Generator, label, modality_shift: float,
                         size: int) -> np.ndarray:
    """A (size, size, 3) uint8 grey image whose luminance texture encodes
    the 8 labels: a grating's orientation and three frequencies from
    labels 0, 1, 3 and 4, a checkerboard where label 2 (BWV) is set. Each
    parameter is jittered around its label's value, so instance
    discrimination has to encode it, and texture survives the colour
    augmentations of stage 1."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    phase = rng.uniform(0, 2 * np.pi, 4)
    theta = np.pi * (label[0] + rng.uniform(0.1, 0.9)) / 5.0 + modality_shift
    f1 = 6 + 3 * (label[1] + rng.uniform(0.1, 0.9))
    f2 = 4 + 4 * (label[3] + rng.uniform(0.1, 0.9))
    f3 = 5 + 5 * (label[4] + rng.uniform(0.1, 0.9))
    u = xx * np.cos(theta) + yy * np.sin(theta)
    tex = 0.5 * np.sin(2 * np.pi * f1 * u + phase[0])
    tex += 0.4 * np.sin(2 * np.pi * f2 * yy + phase[1])
    tex += 0.3 * np.sin(2 * np.pi * f3 * xx + phase[2])
    if label[2]:  # BWV: a checkerboard
        tex += rng.uniform(0.3, 0.5) * np.sign(
            np.sin(2 * np.pi * 8 * xx + phase[3])
            * np.sin(2 * np.pi * 8 * yy))
    base = 128 + 55 * tex / 1.6
    img = np.stack([base, base, base], axis=-1)
    noise = rng.normal(0, 10, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def make_fake_derm7pt(root: str, n_cases: int = 24, img_size: int = 160,
                      seed: int = 0, splits=None, structured: bool = False,
                      ext: str = "png") -> str:
    """Write a synthetic Derm7pt tree under `root`: meta.csv,
    {train,valid,test}_indexes.csv and images/case{i:04d}_{derm,clinic}.ext,
    each image `img_size` +- 16 pixels a side. Returns `root`.

    splits: (n_train, n_valid, n_test) summing to n_cases, e.g. the
      release's (413, 203, 395); by default n/2, n/4 and the rest.
    structured: `render_label_texture` images instead of uniform noise,
      so that what SSL learns can be measured.
    ext: the image container ("jpg" goes through the libjpeg loader where
      it builds, OpenCV elsewhere)."""
    import cv2
    import pandas as pd

    if splits is None:
        n_tr, n_va = n_cases // 2, n_cases // 4
    else:
        n_tr, n_va, n_te = splits
        if n_tr + n_va + n_te != n_cases:
            raise ValueError(f"splits {splits} must sum to n_cases={n_cases}")
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)

    rows = []
    for i in range(n_cases):
        row = {}
        nums = []
        for abbrev in LABEL_ORD:
            cat = GROUPED_SCHEMA[abbrev]
            lab = cat.labels[int(rng.integers(cat.n_classes))]
            nums.append(lab.num)
            names = (lab.names if isinstance(lab.names, (tuple, list))
                     else (lab.names,))
            row[cat.colname] = names[int(rng.integers(len(names)))]
        for kind, shift in (("derm", 0.0), ("clinic", 0.07)):
            h = img_size + int(rng.integers(-16, 16))
            w = img_size + int(rng.integers(-16, 16))
            if structured:
                img = render_label_texture(rng, nums, shift,
                                           max(h, w))[:h, :w]
            else:
                img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            rel = f"case{i:04d}_{kind}.{ext}"
            cv2.imwrite(os.path.join(img_dir, rel), img)
            row[kind] = rel
        row.update({"elevation": "flat", "sex": "male", "location": "back"})
        rows.append(row)

    pd.DataFrame(rows).to_csv(os.path.join(root, "meta.csv"), index=False)
    perm = rng.permutation(n_cases)
    split_files = {
        "train_indexes.csv": perm[:n_tr],
        "valid_indexes.csv": perm[n_tr:n_tr + n_va],
        "test_indexes.csv": perm[n_tr + n_va:],
    }
    for fname, idx in split_files.items():
        pd.DataFrame({"indexes": idx}).to_csv(os.path.join(root, fname),
                                              index=False)
    return root


def synthetic_canvas_batch(batch_size: int, canvas: int = 320, seed: int = 0):
    """Random uint8 canvases (B, S, S, 3), valid sizes (B, 2) int32 and
    multi-labels (B, 8) int32."""
    rng = np.random.default_rng(seed)
    canvases = rng.integers(0, 256, (batch_size, canvas, canvas, 3),
                            dtype=np.uint8)
    hw = np.stack([
        rng.integers(canvas // 2, canvas + 1, batch_size),
        rng.integers(canvas // 2, canvas + 1, batch_size),
    ], axis=1).astype(np.int32)
    labels = rng.integers(0, 2, (batch_size, 8)).astype(np.int32)
    return canvases, hw, labels


class SyntheticPairedData:
    def __init__(self, n: int, canvas: int = 320, seed: int = 0):
        self.n = n
        self.derm, self.derm_hw, self.labels = synthetic_canvas_batch(
            n, canvas, seed)
        self.clinic, self.clinic_hw, _ = synthetic_canvas_batch(
            n, canvas, seed + 1)
        self.meta_codes = synthetic_meta_codes(n, seed)
        self.meta_vocab_sizes = list(META_VOCAB_SIZES)

    def steps_per_epoch(self, batch_size: int) -> int:
        return (self.n + batch_size - 1) // batch_size

    def epoch_order(self, epoch: int, seed: int = 3407,
                    shuffle: bool = True) -> np.ndarray:
        if not shuffle:
            return np.arange(self.n)
        return np.random.default_rng(seed + epoch).permutation(self.n)

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 3407,
                shuffle: bool = True):
        """Fixed-size batches of the epoch's order; see
        `iter_batch_selections` for the padding of the last one."""
        order = self.epoch_order(epoch, seed, shuffle)
        for sel, mask in iter_batch_selections(order, batch_size):
            yield Batch(derm=self.derm[sel], derm_hw=self.derm_hw[sel],
                        clinic=self.clinic[sel], clinic_hw=self.clinic_hw[sel],
                        label=self.labels[sel], index=sel.astype(np.int32),
                        mask=mask, meta=self.meta_codes[sel])


def synthetic_paired_data(n: int, canvas: int = 320,
                          seed: int = 0) -> PairedImageData:
    """`SyntheticPairedData(n, canvas, seed)`'s cases as a
    `PairedImageData`."""
    s = SyntheticPairedData(n, canvas, seed)
    data = PairedImageData.from_canvases(s.derm, s.derm_hw, s.clinic,
                                         s.clinic_hw, s.labels)
    data.meta_codes, data.meta_vocab_sizes = s.meta_codes, s.meta_vocab_sizes
    return data
