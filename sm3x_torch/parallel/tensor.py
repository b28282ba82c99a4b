"""Tensor parallelism over the model axis of the run's grid (counterpart of
the reference's GSPMD placement under --mesh-model > 1:
sm3x/core/mesh.py `label_head_shardings`, `vit_tp_shardings`;
sm3x/train/common.py `_maybe_tp_state`; sm3x/train/backbone_train.py
`_place_state`).

Each rank holds its slices as real parameters, Megatron style, so AdamW
gives a split weight split moments by itself. Three operators join the
slices, each a `torch.autograd.Function` over the model group, and each
rank of a model group computes the same everywhere outside the split
layers:
  copy_to_model       forward the identity, backward an all-reduce (the
                      input of a column-parallel layer: every rank's
                      slice sends its gradient back to the shared input);
  reduce_from_model   forward an all-reduce of the partial outputs of a
                      row-parallel layer, backward the identity;
  gather_from_model   forward an all-gather along a dim, backward this
                      rank's slice of the gradient.
The two in-tree collectives that look alike do not fit: `all_reduce_sum`
reduces in both directions and `gather_rows_autograd` sums the gradient
before it slices; as every model rank computes the same downstream, both
would multiply a gradient by the model size.

Sums of bf16 partials are taken in float32 and cast once. Under gloo a
CUDA tensor's gather goes through the host (`collectives.gather_list`).

`tensor_parallel(model, mesh, kind)` splits the modules of one kind in
place ("vit": every `ViTBlock`; "labels": every `MultiLabelProjector`),
from the whole model that every rank built from the seed, and returns a
`Split`: the plan of sm3x_torch.core.mesh that says which key is split
along which dim, and the whole layout, so that checkpoints are written and
read whole, with the keys and shapes of a one-process run
(`Split.whole_state`, `Split.local_state`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from sm3x_torch.core.mesh import (Mesh, head_of, label_head_shardings,
                                  vit_tp_shardings)
from sm3x_torch.parallel.collectives import (gather_list, gather_objects,
                                             group_info)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of `x`, in at least float32."""
    y = x.to(torch.promote_types(x.dtype, torch.float32), copy=True)
    dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = group_info(group)[0]
        return torch.cat(gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The shared input of a column-parallel layer (see the module's
    docstring)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group of a row-parallel layer's partial
    outputs, in at least float32: the caller adds the bias and casts."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model group's slices of `x` side by side along `dim`, in rank
    order."""
    return _GatherFromModel.apply(x, dim, group)


# ---------------------------------------------------------------------------
# Slicing and joining state dicts by a plan
# ---------------------------------------------------------------------------

def shard_state_dict(sd: dict, plan: Callable, model: int,
                     index: int) -> dict:
    """Rank `index`'s part of a whole state dict (model keys, or a dict of
    AdamW moments by parameter key): where `plan(key, shape, model)` names
    a dim, that dim's block `index` of `model`; for a label head's key
    (sm3x_torch.core.mesh.head_of) the key itself if the head is in block
    `index` of the heads, else nothing; every other key whole."""
    heads = 1 + max((h for h in map(head_of, sd) if h is not None),
                    default=-1)
    out = {}
    for k, v in sd.items():
        dim, head = plan(k, tuple(v.shape), model), head_of(k)
        if dim is None:
            out[k] = v
        elif head is not None:
            if head * model // heads == index:
                out[k] = v
        else:
            per = v.shape[dim] // model
            out[k] = v.narrow(dim, index * per, per)
    return out


def unshard_state_dict(shards: list, plan: Callable, shapes: dict) -> dict:
    """The whole state dict from every rank's part (`shards`, in model
    rank order): `shapes` holds the whole shape of every key, in the whole
    dict's order (a key no part has is left out). Split tensors are
    concatenated along their dim, a label head's keys come from the rank
    that holds it, the rest from the first part."""
    model = len(shards)
    out = {}
    for k, shape in shapes.items():
        have = [s[k] for s in shards if k in s]
        if not have:
            continue
        dim = plan(k, tuple(shape), model)
        if dim is None or head_of(k) is not None:
            out[k] = have[0]
        else:
            out[k] = torch.cat(have, dim=dim)
    return out


# ---------------------------------------------------------------------------
# A split model
# ---------------------------------------------------------------------------

PLANS = {"vit": vit_tp_shardings, "labels": label_head_shardings}


@dataclasses.dataclass
class Split:
    """A model split over the model axis of `mesh` by `plan`; `shapes` are
    the whole model's state-dict keys and shapes, `params` its parameter
    names, each in the order of a one-process run."""
    mesh: Mesh
    plan: Callable
    shapes: dict
    params: list

    @property
    def group(self):
        return self.mesh.model_group

    def _split_keys(self, local: dict) -> list:
        model = self.mesh.model
        return [k for k, v in local.items()
                if self.plan(k, self._shape(k, v), model) is not None]

    def _shape(self, k: str, v: torch.Tensor) -> tuple:
        """The whole shape of entry `k`: the parameter's, or the entry's own
        for a per-parameter scalar (AdamW's `step`)."""
        whole = self.shapes.get(k)
        return tuple(v.shape) if whole is None or v.dim() != len(whole) \
            else whole

    def gather(self, local: dict) -> dict:
        """The whole dict from every model rank's `local` one (model keys
        or a per-parameter entry of the optimizer's state). Collective over
        the model group: one gather of the split keys' names, then one a
        split key, by position (the ranks' split keys pair up one to one
        in shape)."""
        split = self._split_keys(local)
        names = gather_objects(split, self.group)
        shards = [{k: v for k, v in local.items() if k not in split}
                  for _ in names]
        for i, k in enumerate(split):
            x = local[k]
            for r, part in enumerate(gather_list(x.reshape(-1), self.group)):
                shards[r][names[r][i]] = part.view(x.shape)
        present = set().union(*map(set, shards))
        shapes = {k: self._shape(k, next(s[k] for s in shards if k in s))
                  for k in self.shapes if k in present}
        return unshard_state_dict(shards, self.plan, shapes)

    def shard(self, whole: dict) -> dict:
        """This rank's part of a whole dict."""
        return shard_state_dict(whole, self.plan, self.mesh.model,
                                self.mesh.model_index)

    # -- the optimizer, by parameter name --------------------------------

    def _names(self, model: torch.nn.Module, optimizer) -> list:
        by_id = {id(p): n for n, p in model.named_parameters()}
        if len(optimizer.param_groups) != 1:
            raise ValueError("a split model's optimizer has one param group")
        return [by_id[id(p)] for p in optimizer.param_groups[0]["params"]]

    def _whole_names(self, local_names: list) -> list:
        """The optimizer's parameters of a one-process run, in its order:
        those of every model rank (collective)."""
        every = set().union(*gather_objects(local_names, self.group))
        return [n for n in self.params if n in every]

    def whole_optimizer_state(self, model, optimizer) -> dict:
        """`optimizer.state_dict()` of a one-process run (collective)."""
        local = optimizer.state_dict()
        names = self._names(model, optimizer)
        whole_names = self._whole_names(names)
        entries = sorted({e for s in local["state"].values() for e in s})
        per_entry = {e: self.gather({names[i]: s[e] for i, s in
                                     local["state"].items() if e in s})
                     for e in entries}
        state = {}
        for i, n in enumerate(whole_names):
            got = {e: per_entry[e][n] for e in entries if n in per_entry[e]}
            if got:
                state[i] = got
        group = dict(local["param_groups"][0],
                     params=list(range(len(whole_names))))
        return {"state": state, "param_groups": [group]}

    def local_optimizer_state(self, whole: dict, model, optimizer) -> dict:
        """This rank's `optimizer.state_dict()` from a one-process run's
        (collective)."""
        names = self._names(model, optimizer)
        whole_names = self._whole_names(names)
        if len(whole_names) != len(whole["param_groups"][0]["params"]):
            raise ValueError(
                f"the checkpoint's optimizer holds "
                f"{len(whole['param_groups'][0]['params'])} tensors, this "
                f"run's {len(whole_names)}")
        entries = sorted({e for s in whole["state"].values() for e in s})
        per_entry = {e: self.shard({whole_names[i]: s[e] for i, s in
                                    whole["state"].items() if e in s})
                     for e in entries}
        state = {}
        for j, n in enumerate(names):
            got = {e: per_entry[e][n] for e in entries if n in per_entry[e]}
            if got:
                state[j] = got
        group = dict(whole["param_groups"][0], params=list(range(len(names))))
        return {"state": state, "param_groups": [group]}


def tensor_parallel(model: torch.nn.Module, mesh: Mesh, kind: str,
                    **plan_args) -> Optional[Split]:
    """Split `model`'s modules of `kind` ("vit" or "labels") in place over
    the model axis of `mesh`; None (and nothing split) with model 1.
    `plan_args` bind the plan's own arguments (`num_labels`)."""
    if mesh.model == 1:
        return None
    plan = functools.partial(PLANS[kind], **plan_args)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    params = [n for n, _ in model.named_parameters()]
    for mod in list(model.modules()):
        if getattr(mod, "tp_kind", None) == kind:
            mod.split_for_model(mesh.model, mesh.model_index,
                                mesh.model_group)
    return Split(mesh, plan, shapes, params)
