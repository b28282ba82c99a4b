"""The run's (data, model) grid of processes and the rows each process
holds (counterpart of sm3x/core/mesh.py).

The JAX package names a ("data", "model") mesh of devices and lets GSPMD
place the batch on "data" and, under --mesh-model > 1, the label heads or
the ViT blocks on "model". The port runs one process a GPU over
torch.distributed, so its mesh is a grid of ranks in the reference's
device order: rank r sits at data index r // model and model index
r % model. The ranks of one model group (one data index) hold the same
rows of every batch and their slices of the split weights
(sm3x_torch.parallel.tensor); the ranks of one data group (one model
index) split the batch, and everything that splits or reduces over the
batch runs over that group. With model 1 the data group is the whole run,
and nothing here differs from a run without a model axis.

Rank d of the data axis holds rows [d B / D, (d + 1) B / D) of a global
batch of B, the order JAX's data axis gives.

`batch_rows` marks a block in which random draws are made at the global
batch's shape and each rank keeps its rows (sm3x_torch.models.transformer
.dropout: the MLC head's and the tri-modal metadata views'), so that a
run's random numbers depend neither on the data size nor on the model
index.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Optional

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The grid and this rank's place on it. `data_group` is the
    torch.distributed group of this rank's data axis (None: the whole run,
    as with model 1), `model_group` that of its model axis (None with
    model 1)."""
    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


# the grid of this process's run: one process is one rank of one run, as
# torch.distributed's default group is one per process
_grid: dict = {}


def _world_group():
    return torch.distributed.group.WORLD if is_distributed() else None


def make_mesh(model: int = 1) -> Mesh:
    """The run's grid: data = the processes of the run over `model`. A
    world that `model` does not divide is refused. Every rank must call it
    with the same `model` (the groups are made collectively, in one
    order); a second call with the same `model` returns the first grid."""
    rank, world = process_info()
    if model < 1 or world % model:
        raise ValueError(f"--mesh-model {model} does not divide the {world} "
                         f"process(es) of the run")
    key = (model, world, _world_group())
    if _grid.get("key") == key:
        return _grid["mesh"]
    data_group = model_group = None
    if model > 1:
        new_group = torch.distributed.new_group
        for m in range(model):
            g = new_group([d * model + m for d in range(world // model)])
            if m == rank % model:
                data_group = g
        for d in range(world // model):
            g = new_group([d * model + m for m in range(model)])
            if d == rank // model:
                model_group = g
    mesh = Mesh(world // model, model, rank // model, rank % model,
                data_group, model_group)
    _grid.update(key=key, mesh=mesh)
    return mesh


def current_mesh() -> Mesh:
    """The grid `make_mesh` made for this run; without one, every process
    of the run on the data axis."""
    rank, world = process_info()
    mesh = _grid.get("mesh")
    if mesh is not None and _grid["key"][1:] == (world, _world_group()):
        return mesh
    return Mesh(data=world, data_index=rank)


def data_group():
    """The group of this rank's data axis (None: the whole run)."""
    return current_mesh().data_group


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
        """The ranks of the data axis that share the batch."""
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
    """This rank's rows of a global batch: those of its data index of the
    run's data axis (all of them on one process). A batch that the data
    axis does not divide is refused."""
    if rank is None or world is None:
        mesh = current_mesh()
        rank, world = mesh.data_index, mesh.data
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} (-b) is not a "
                         f"multiple of the {world} processes of the run's "
                         f"data axis")
    per = global_batch // world
    return Rows(rank * per, (rank + 1) * per, global_batch)


# ---------------------------------------------------------------------------
# Plans: which dim of a state-dict key a model axis of `model` splits
# ---------------------------------------------------------------------------

_HEAD = re.compile(r"(?:^|\.)projectors\.(\d+)\.")
_BLOCK = re.compile(r"block\d+")


def head_of(key: str) -> Optional[int]:
    """The label head a key of a `MultiLabelProjector` belongs to
    (`...projectors.projectors.{h}.*`), or None."""
    found = _HEAD.search(key)
    return None if found is None else int(found.group(1))


def label_head_shardings(key: str, shape, model: int,
                         num_labels: int = 8) -> Optional[int]:
    """The counterpart of the reference's `label_head_shardings`: the
    stacked (num_labels, ...) leaves under a `projectors` subtree split
    their heads dim over the model axis, unless `model` does not divide
    `num_labels`; every other key is replicated (None). The port keeps a
    head a module, so the heads dim is the `{h}` of
    `...projectors.projectors.{h}.*`: for those keys the answer is 0, the
    dim of the stack of the heads' tensors, and a rank holds heads
    [m L / M, (m + 1) L / M) whole (each key of such a head, its
    `num_batches_tracked` too). `shape` is the head's own tensor's."""
    del shape   # a head moves whole, whatever its tensors' shapes
    if model <= 1 or num_labels % model:
        return None
    return 0 if head_of(key) is not None else None


def vit_tp_shardings(key: str, shape, model: int,
                     head_dim: int = 64) -> Optional[int]:
    """The counterpart of the reference's `vit_tp_shardings` (Megatron):
    in every `block<i>`, q/k/v weights (H * hd, D) and biases split their
    heads (dim 0, column-parallel), the attention `out` weight (D, H * hd)
    its heads (dim 1, row-parallel; its bias is replicated), `fc1` weight
    (hidden, D) and bias the hidden dim (0), `fc2` weight (D, hidden) the
    hidden dim (1; bias replicated). A dim the model axis does not divide
    (heads, or hidden) stays replicated, and so does everything else:
    patch embed, LayerNorms, cls / pos, the projectors outside the blocks.
    Returns the dim of the port's tensor to split, or None."""
    parts = key.split(".")
    if model <= 1 or len(parts) < 3 or not any(
            _BLOCK.fullmatch(p) for p in parts[:-2]):
        return None
    leaf, parent, grand = parts[-1], parts[-2], parts[-3]
    shape = tuple(shape)
    if grand == "attn" and parent in ("query", "key", "value"):
        if leaf in ("weight", "bias") and len(shape) == (
                2 if leaf == "weight" else 1):
            return 0 if (shape[0] // head_dim) % model == 0 else None
    elif grand == "attn" and parent == "out":
        if leaf == "weight" and len(shape) == 2:
            return 1 if (shape[1] // head_dim) % model == 0 else None
    elif parent == "fc1":
        if leaf in ("weight", "bias") and len(shape) == (
                2 if leaf == "weight" else 1):
            return 0 if shape[0] % model == 0 else None
    elif parent == "fc2":
        if leaf == "weight" and len(shape) == 2:
            return 1 if shape[1] % model == 0 else None
    return None


def pad_to_multiple(n: int, k: int) -> int:
    """`n` rounded up to a multiple of `k` (the reference's public helper
    of the same name)."""
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


# imported last: sm3x_torch.parallel re-exports this module's names, so the
# package may start from here and must find them defined
from sm3x_torch.parallel.collectives import (  # noqa: E402
    is_distributed, process_info)
