"""Process-group bring-up and the collectives the trainers use
(counterpart of sm3x/parallel/collectives.py, over torch.distributed).

The port runs one process a GPU: rank r of N binds `cuda:LOCAL_RANK` and
holds rows [r B / N, (r + 1) B / N) of every global batch of B
(sm3x_torch.core.mesh.local_rows). NCCL joins the processes on CUDA, gloo
on the CPU; the collectives below take whichever the group has, and where
gloo lacks a form (a gather into one tensor; any gather of CUDA tensors,
which gloo reduces and broadcasts only) they use the form it has (a gather
of host tensors into a list).

Everything here is a no-op, or the identity, without a process group;
with one, every rank must call each function in the same order. A
function with a `group` runs over that torch.distributed group (None: the
whole run); the trainers pass the data group of the run's grid
(sm3x_torch.core.mesh.data_group) wherever the batch is split or reduced,
and tensor parallelism (sm3x_torch.parallel.tensor) its model group.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


def is_distributed() -> bool:
    """A process group is up (of any size, 1 included)."""
    return dist.is_available() and dist.is_initialized()


def process_info() -> tuple:
    """(rank, world size) of this process; (0, 1) without a process group.
    Touches no device, so it can run before `distributed_initialize` has
    bound one."""
    if not is_distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def group_info(group=None) -> tuple:
    """(rank, size) of this process in `group` (None: the whole run);
    (0, 1) without a process group."""
    if not is_distributed():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def is_main_process() -> bool:
    """Rank 0, or no process group at all: the process that writes the
    run's files (checkpoints, results.csv, configs.txt, stdout)."""
    return process_info()[0] == 0


def distributed_initialize(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = 1800.0) -> bool:
    """Join the run's process group; False where there is none to join.

    `coordinator` "host:port" with `num_processes` and `process_id` is a
    `tcp://` rendezvous (the reference's --coordinator flags); without it,
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    is read, and a process that has neither runs alone. `backend` defaults
    to NCCL where CUDA is there and gloo elsewhere; an NCCL process binds
    `cuda:LOCAL_RANK` (torchrun) or `cuda:process_id % cards` before the
    group comes up."""
    if is_distributed():
        return True
    env = os.environ
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        init, world, rank = f"tcp://{coordinator}", int(num_processes), \
            int(process_id)
        local = int(env.get("LOCAL_RANK", rank))
    elif "WORLD_SIZE" in env and "RANK" in env:
        init, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", rank))
    else:
        return False
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a world of {world}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group, where there is one."""
    if is_distributed():
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where a host buffer goes for a collective: the bound card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` (the same shape on each) concatenated along dim 0
    in rank order; no gradient. One collective."""
    _, world = group_info(group)
    if world == 1:
        return x
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    return torch.cat(gather_list(x, group))


def gather_list(x: torch.Tensor, group=None) -> list:
    """Every rank's `x` (the same shape on each), a tensor a rank in rank
    order, on `x`'s device; no gradient. One collective."""
    _, world = group_info(group)
    if world == 1:
        return [x]
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        return parts
    # gloo gathers host tensors only: a CUDA tensor goes through the host
    here = x.cpu()
    parts = [torch.empty_like(here) for _ in range(world)]
    dist.all_gather(parts, here, group=group)
    return [p.to(x.device) for p in parts]


def gather_objects(obj, group=None) -> list:
    """Every rank's picklable `obj`, a list in rank order. One collective
    (two under the hood: sizes, then bytes)."""
    _, world = group_info(group)
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_string(s: str, max_len: int = 4096) -> str:
    """Rank 0's `s` on every rank (the run directory that rank 0
    resolved); `s` as it is without a process group."""
    _, world = process_info()
    if world == 1:
        return s
    raw = s.encode("utf-8")
    if len(raw) > max_len:
        raise ValueError(f"string of {len(raw)} bytes, more than {max_len}")
    buf = torch.zeros(max_len + 8, dtype=torch.uint8)
    buf[:8] = torch.tensor([len(raw)], dtype=torch.int64).view(torch.uint8)
    if raw:
        buf[8:8 + len(raw)] = torch.frombuffer(bytearray(raw),
                                               dtype=torch.uint8)
    buf = buf.to(_comm_device())
    dist.broadcast(buf, 0)
    buf = buf.cpu()
    n = int(buf[:8].view(torch.int64))
    return bytes(buf[8:8 + n].numpy()).decode("utf-8")


def max_over_ranks(value: int) -> int:
    """The largest of the ranks' integers, on every rank."""
    if process_info()[1] == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t)


def host_gather(x, axis: int = 0, group=None) -> np.ndarray:
    """Every rank's array (a tensor or numpy array of one shape on every
    rank) concatenated along `axis` in rank order, as a host numpy array
    on every rank."""
    return host_gather_tree({"x": x}, axis, group)["x"]


def host_gather_tree(tree, axis: int = 0, group=None):
    """`host_gather` over a dict / list / tuple of arrays in ONE
    collective: each rank's leaves go to the host, their bytes into one
    buffer, the buffers of all ranks into one gather; each leaf comes back
    as the concatenation of every rank's along `axis`. Every rank must
    give leaves of the same shapes and types."""
    leaves, spec = pytree.tree_flatten(tree)
    host = [np.ascontiguousarray(
        x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
        for x in leaves]
    _, world = group_info(group)
    if world == 1:
        return pytree.tree_unflatten(host, spec)
    flat = np.concatenate([a.reshape(-1).view(np.uint8) for a in host]) \
        if host else np.zeros(0, np.uint8)
    got = gather_rows(torch.from_numpy(flat.copy())[None].to(
        _comm_device()), group).cpu().numpy()   # (world, nbytes)
    out, at = [], 0
    for a in host:
        n = a.nbytes
        parts = [got[r, at:at + n].view(a.dtype).reshape(a.shape)
                 for r in range(world)]
        out.append(np.concatenate(parts, axis=axis))
        at += n
    return pytree.tree_unflatten(out, spec)


def all_gather_varlen(x: torch.Tensor, group=None):
    """Rows of a different count on each rank: (gathered (world, max, ...),
    lengths (world,)), each rank's rows padded with zeros to the longest;
    slice rank r's with `gathered[r, :lengths[r]]`. Two collectives: the
    lengths, then the padded rows. The counterpart of the reference's
    public helper of the same name (sm3x/parallel/__init__.py)."""
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    lengths = gather_rows(n, group)
    top = int(lengths.max())
    pad = x.new_zeros((top,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    return gather_rows(pad[None], group), lengths


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its backward is the sum over ranks of the
    gradients, so the gradient of every rank's input sees every rank's
    use of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of `group` (`x` itself
    without a process group)."""
    if not is_distributed():
        return x
    return _AllReduceSum.apply(x, group)


def cross_replica_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable mean of `x` over the ranks of `group`."""
    _, world = group_info(group)
    return all_reduce_sum(x, group) / world if world > 1 else x


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows in rank order. Backward: the sum over
    ranks of the gradient of the gathered rows, then this rank's slice:
    each rank's loss on the gathered rows sends its gradient to the rows'
    owners (DDP then averages the ranks' parameter gradients)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        ctx.rank = dist.get_rank(group)
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(0, ctx.rank * ctx.n, ctx.n), None


def gather_rows_autograd(x: torch.Tensor, group=None) -> torch.Tensor:
    """`gather_rows` with a gradient (see `_GatherRows`); `x` itself on
    one process."""
    if group_info(group)[1] == 1:
        return x
    return _GatherRows.apply(x, group)
