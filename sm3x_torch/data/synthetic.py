"""In-memory paired canvases for runs without a dataset (counterpart of
sm3x/data/synthetic.py `synthetic_canvas_batch`, made with numpy alone).

`synthetic_canvas_batch` draws the same canvases, valid sizes and labels as
the JAX package's function for the same arguments. `SyntheticPairedData`
pairs two such draws (derm from `seed`, clinic from `seed + 1`) behind the
interface the trainers read from a dataset (`n`, `steps_per_epoch`,
`batches`; sm3x/data/pipeline.py:171-190).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PairedBatch:
    derm: np.ndarray        # (B, S, S, 3) uint8
    derm_hw: np.ndarray     # (B, 2) int32
    clinic: np.ndarray
    clinic_hw: np.ndarray
    index: np.ndarray       # (B,) int32: the cases' positions in the data


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
        self.derm, self.derm_hw, _ = synthetic_canvas_batch(n, canvas, seed)
        self.clinic, self.clinic_hw, _ = synthetic_canvas_batch(
            n, canvas, seed + 1)

    def steps_per_epoch(self, batch_size: int) -> int:
        return self.n // batch_size

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 3407):
        """Full batches of a per-epoch permutation."""
        order = np.random.default_rng(seed + epoch).permutation(self.n)
        for k in range(self.steps_per_epoch(batch_size)):
            sel = order[k * batch_size:(k + 1) * batch_size]
            yield PairedBatch(self.derm[sel], self.derm_hw[sel],
                              self.clinic[sel], self.clinic_hw[sel],
                              sel.astype(np.int32))
