"""In-memory paired canvases for runs without a dataset (counterpart of
sm3x/data/synthetic.py `synthetic_canvas_batch`, made with numpy alone).

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

import numpy as np

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
