"""Device-resident dataset (counterpart of sm3x/data/device_data.py).

Derm7pt is tiny (about 1k pairs): the whole uint8 canvas cache is a small
share of the card's memory. Uploaded once, it takes the upload out of every
step: a batch is an index gather on the device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from sm3x_torch.core.mesh import local_rows
from sm3x_torch.data.pipeline import (Batch, PairedImageData,
                                      iter_batch_selections)
from sm3x_torch.utils.profiling import annotate, count


class DeviceData:
    """Wraps a PairedImageData with its canvases and sizes on `device`.
    `batches` yields Batch objects whose derm / clinic fields are device
    tensors gathered by index; the order and the wrap-padding are those of
    the host data. Labels, index, mask and meta stay on the host. With
    `local`, the gather takes this process's rows of each global batch
    (sm3x_torch.data.multihost); label, index and mask stay global."""

    def __init__(self, data: PairedImageData, device, local: bool = False):
        self.local = local
        self.device = torch.device(device)
        self.n = data.n
        self.labels = data.labels
        self.meta_codes = getattr(data, "meta_codes", None)
        self.meta_vocab_sizes = getattr(data, "meta_vocab_sizes", None)
        self._derm = torch.from_numpy(data.derm.canvases).to(self.device)
        self._derm_hw = torch.from_numpy(data.derm.valid_hw).to(self.device)
        self._clinic = torch.from_numpy(data.clinic.canvases).to(self.device)
        self._clinic_hw = torch.from_numpy(
            data.clinic.valid_hw).to(self.device)
        self._host = data

    def steps_per_epoch(self, batch_size: int) -> int:
        return (self.n + batch_size - 1) // batch_size

    def epoch_order(self, epoch: int, seed: int = 3407, shuffle: bool = True):
        return self._host.epoch_order(epoch, seed, shuffle)

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 3407,
                shuffle: bool = True, pad: str = "wrap") -> Iterator[Batch]:
        order = self.epoch_order(epoch, seed, shuffle)
        rows = slice(None)
        if self.local:
            mine = local_rows(batch_size)
            rows = slice(mine.start, mine.stop)
        for sel, mask in iter_batch_selections(order, batch_size):
            with annotate("feed.batch"):
                # from pageable memory: the copy waits for the stream
                with annotate("feed.upload"):
                    count("host.device_waits")
                    idx = torch.from_numpy(np.ascontiguousarray(
                        sel[rows], np.int64)).to(self.device)
                batch = Batch(derm=self._derm[idx],
                              derm_hw=self._derm_hw[idx],
                              clinic=self._clinic[idx],
                              clinic_hw=self._clinic_hw[idx],
                              label=self.labels[sel],
                              index=sel.astype(np.int32), mask=mask,
                              meta=(None if self.meta_codes is None
                                    else self.meta_codes[sel]))
            yield batch
