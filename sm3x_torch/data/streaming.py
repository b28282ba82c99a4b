"""Streaming (decode-on-the-fly) paired dataset: the port's own copy of
sm3x/data/streaming.py, which it does not import.

PairedImageData decodes every image once into a canvas cache in RAM: right
for Derm7pt-scale splits (about 2k images, a few hundred MB), and what lets
the whole dataset live on the device (sm3x_torch.data.device_data). But the
cache grows with the dataset.

StreamingPairedData keeps the same consumer interface (`n`, `labels`,
`epoch_order`, `steps_per_epoch`, `batches`) with memory of
`decode_ahead` batches instead: a background thread decodes the next
batches' JPEGs into canvases (the multi-threaded libjpeg loader,
sm3x_torch/native/loader.cpp) while the device consumes the current one;
augmentation stays on the device. `wrap_for_device` composes it with
`PrefetchData`, so the upload overlaps too: decode batch k+2, upload batch
k+1, compute batch k.

Select it with --no-cache-images on any trainer CLI.
"""

from __future__ import annotations

import numpy as np

from sm3x_torch.data.pipeline import (Batch, decode_canvas_batch,
                                iter_batch_selections)


class StreamingPairedData:
    """Paired derm/clinic dataset that decodes batches just-in-time."""

    def __init__(self, derm_paths, clinic_paths, labels,
                 cache_size: int = 320, crop_amount: int = 25,
                 workers: int = 8, meta_codes=None, meta_vocab_sizes=None,
                 decode_ahead: int = 2):
        if decode_ahead < 1:
            raise ValueError(
                f"decode_ahead must be >= 1, got {decode_ahead}")
        self.derm_paths = list(derm_paths)
        self.clinic_paths = list(clinic_paths)
        self.labels = np.asarray(labels, dtype=np.int32)
        self.n = len(self.derm_paths)
        self.cache_size = cache_size
        self.crop_amount = crop_amount
        self.workers = workers
        self.decode_ahead = decode_ahead
        self.meta_codes = (None if meta_codes is None
                           else np.asarray(meta_codes, dtype=np.int32))
        self.meta_vocab_sizes = meta_vocab_sizes

    @classmethod
    def from_meta(cls, meta, split: str, cache_size: int = 320,
                  workers: int = 8, decode_ahead: int = 2):
        d, c, y = meta.examples(split)
        idx = meta.split_indexes(split)
        return cls(d, c, y, cache_size, meta.crop_amount, workers,
                   meta_codes=meta.meta_codes[idx],
                   meta_vocab_sizes=[len(meta.meta_vocabs[f])
                                     for f in meta.meta_fields],
                   decode_ahead=decode_ahead)

    # identical order/padding semantics to PairedImageData so switching
    # feeds never changes which samples a step sees
    def epoch_order(self, epoch: int, seed: int = 3407, shuffle: bool = True):
        idx = np.arange(self.n)
        if shuffle:
            rng = np.random.default_rng(seed + epoch)
            rng.shuffle(idx)
        return idx

    def steps_per_epoch(self, batch_size: int) -> int:
        return (self.n + batch_size - 1) // batch_size

    def decode_rows(self, sel) -> tuple:
        """Decode only the given rows -> (derm, derm_hw, clinic,
        clinic_hw)."""
        derm, derm_hw = decode_canvas_batch(
            [self.derm_paths[i] for i in sel], self.cache_size,
            self.crop_amount, self.workers)
        clinic, clinic_hw = decode_canvas_batch(
            [self.clinic_paths[i] for i in sel], self.cache_size,
            self.crop_amount, self.workers)
        return derm, derm_hw, clinic, clinic_hw

    def _decode_batch(self, sel: np.ndarray, mask: np.ndarray) -> Batch:
        k = len(sel)
        derm, derm_hw, clinic, clinic_hw = self.decode_rows(sel)
        assert len(derm) == k
        return Batch(
            derm=derm, derm_hw=derm_hw, clinic=clinic, clinic_hw=clinic_hw,
            label=self.labels[sel], index=sel.astype(np.int32), mask=mask,
            meta=(None if self.meta_codes is None else self.meta_codes[sel]),
        )

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 3407,
                shuffle: bool = True, pad: str = "wrap"):
        from sm3x_torch.data.prefetch import iter_with_producer

        order = self.epoch_order(epoch, seed, shuffle)
        yield from iter_with_producer(
            lambda: (self._decode_batch(sel, mask)
                     for sel, mask in iter_batch_selections(order,
                                                            batch_size)),
            self.decode_ahead, "sm3x-torch-stream-decode")
