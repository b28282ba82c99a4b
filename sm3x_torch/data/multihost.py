"""This process's rows of every global batch (counterpart of
sm3x/data/multihost.py).

Every rank computes the same epoch order (`epoch_order`, seeded) and the
same selections (`iter_batch_selections`), so each step's samples are
those of a single-process run. The rank at data index d of a data axis of
D then gathers, or decodes when streaming, only rows [d B / D,
(d + 1) B / D) of each selection (`local_batch_rows`) and uploads them; no
process reads another data index's canvases (the ranks of one model group
read the same rows). A batch keeps `label`,
`index`, `mask` and `meta` as full host arrays of the global batch: they
are tiny and the same on every rank, and the trainers take this rank's
rows of them where they need them.

`LocalRows` is the host side (the trainer uploads each batch);
`ProcessShardedData` adds the pinned ring of `PrefetchData` on a producer
thread `depth` batches ahead, so the gather and the copy run beside the
step.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from sm3x_torch.core.mesh import Mesh, current_mesh, local_rows
from sm3x_torch.data.pipeline import (Batch, PairedImageData,
                                      iter_batch_selections)
from sm3x_torch.data.prefetch import DEVICE_FIELDS, PrefetchData


def local_batch_rows(mesh: Mesh, global_batch: int) -> np.ndarray:
    """Global row indices of this process's rows of a batch on `mesh` (the
    rows of its data index), ascending; `arange(global_batch)` on a mesh
    of one data rank."""
    rows = local_rows(global_batch, mesh.data_index, mesh.data)
    return np.arange(rows.start, rows.stop, dtype=np.int64)


class LocalRows:
    """A host dataset's batches cut to this process's rows on the run's
    grid: the canvases and sizes of this rank's rows only; label, index,
    mask and meta of the whole global batch. A canvas cache is gathered, a
    streaming dataset decodes only these rows; any other source's batches
    are sliced."""

    def __init__(self, data):
        self._host = data
        self.n = data.n
        self.labels = data.labels
        self.meta_codes = getattr(data, "meta_codes", None)
        self.meta_vocab_sizes = getattr(data, "meta_vocab_sizes", None)

    def steps_per_epoch(self, batch_size: int) -> int:
        return self._host.steps_per_epoch(batch_size)

    def epoch_order(self, epoch: int, seed: int = 3407, shuffle: bool = True):
        return self._host.epoch_order(epoch, seed, shuffle)

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 3407,
                shuffle: bool = True, pad: str = "wrap") -> Iterator[Batch]:
        host = self._host
        rows = local_batch_rows(current_mesh(), batch_size)
        if not (isinstance(host, PairedImageData)
                or hasattr(host, "decode_rows")):
            for b in host.batches(batch_size, epoch, seed, shuffle):
                yield dataclasses.replace(b, **{
                    f: getattr(b, f)[rows] for f in DEVICE_FIELDS})
            return
        order = self.epoch_order(epoch, seed, shuffle)
        for sel, mask in iter_batch_selections(order, batch_size):
            mine = sel[rows]
            if hasattr(host, "decode_rows"):
                d, dh, c, ch = host.decode_rows(mine)
            else:
                d, dh = host.derm.canvases[mine], host.derm.valid_hw[mine]
                c, ch = host.clinic.canvases[mine], host.clinic.valid_hw[mine]
            yield Batch(derm=d, derm_hw=dh, clinic=c, clinic_hw=ch,
                        label=self.labels[sel], index=sel.astype(np.int32),
                        mask=mask,
                        meta=(None if self.meta_codes is None
                              else self.meta_codes[sel]))


class ProcessShardedData(PrefetchData):
    """The multi-process device feed: `LocalRows` of a host dataset,
    uploaded through the pinned ring on a producer thread `depth` batches
    ahead of the step (CPU tensors on the CPU)."""

    def __init__(self, data, device, depth: int = 2):
        super().__init__(LocalRows(data), device, depth)
