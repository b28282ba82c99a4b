"""The data axis of a run and the rows each process holds (counterpart of
sm3x/core/mesh.py).

The JAX package names a ("data", "model") mesh of devices and lets GSPMD
place the batch on "data". The port runs one process a GPU over
torch.distributed, so its mesh is a record: data = the processes of the
run, model = 1. Rank r of N holds rows [r B / N, (r + 1) B / N) of a
global batch of B, the order JAX's 1-D data axis gives. Tensor
parallelism over "model" (the stacked label heads, the ViT) is not in the
port (ROADMAP.md item 18).

`batch_rows` marks a block in which random draws are made at the global
batch's shape and each rank keeps its rows (sm3x_torch.models.transformer
.dropout: the MLC head's and the tri-modal metadata views'), so that a
run's random numbers do not depend on N.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

from sm3x_torch.parallel.collectives import process_info

DATA_AXIS = "data"
MODEL_AXIS = "model"

TP_LATER = ("tensor parallelism (--mesh-model > 1) is not in the PyTorch "
            "port yet (ROADMAP.md item 18)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int = 1
    model: int = 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def make_mesh(model: int = 1) -> Mesh:
    """The run's mesh: data = the processes of the run (1 without a
    process group); a model axis above 1 is refused."""
    if model != 1:
        raise ValueError(TP_LATER)
    return Mesh(data=process_info()[1], model=1)


@dataclasses.dataclass(frozen=True)
class Rows:
    """Rows [start, stop) of a global batch of `total`."""
    start: int
    stop: int
    total: int

    @property
    def size(self) -> int:
        return self.stop - self.start

    @property
    def world(self) -> int:
        """The processes that share the batch."""
        return self.total // self.size

    def take(self, x, dim: int = 0):
        """This rank's rows of `x` (a tensor or a numpy array) along
        `dim`."""
        if torch.is_tensor(x):
            return x.narrow(dim, self.start, self.size)
        index = [slice(None)] * x.ndim
        index[dim] = slice(self.start, self.stop)
        return x[tuple(index)]


def local_rows(global_batch: int, rank: Optional[int] = None,
               world: Optional[int] = None) -> Rows:
    """This process's rows of a global batch; all of them on one process.
    A batch that the processes do not divide is refused."""
    if rank is None or world is None:
        rank, world = process_info()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} (-b) is not a "
                         f"multiple of the {world} processes of the run")
    per = global_batch // world
    return Rows(rank * per, (rank + 1) * per, global_batch)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


_state = threading.local()


@contextlib.contextmanager
def batch_rows(rows: Optional[Rows]):
    """Inside the block, `current_rows()` is `rows`: random draws over a
    batch are made at `rows.total` and cut to `rows`."""
    before = getattr(_state, "rows", None)
    _state.rows = rows
    try:
        yield
    finally:
        _state.rows = before


def current_rows() -> Optional[Rows]:
    return getattr(_state, "rows", None)
