"""Projection heads (counterpart of sm3x/models/projector.py:
`SSLProjector` :48-78, `_ProjHead` :81, `MultiLabelProjector` :125).

`SSLProjector`: Linear-BN-ReLU twice, then Linear-BN(affine=False); the
linears have no bias. It is an `nn.Sequential`, so its state dict keys are
the reference's `0, 1, 3, 4, 6, 7` indices
(`sm3x.utils.torch_export.export_ssl_projector`).

`MultiLabelProjector`: one head a label, each an `nn.Sequential` under
`projectors.{h}` with the same index convention
(`export_multilabel_projector`): v1 is the SSL stack, v2 drops its middle
layer, v3 is Linear-BN(affine=False), v4 one Linear with a bias, v0 the
identity as a single pseudo-head. The heads' products run as one batched
product over the weights stacked at call time; batch norm runs head by
head, each with its own running statistics.

Tensor parallelism (--mesh-model > 1, sm3x_torch.parallel.tensor):
`split_for_model` keeps heads [m L / M, (m + 1) L / M) of the model axis
(sm3x_torch.core.mesh.label_head_shardings), under their own names
(`projectors.{h}`), so a rank's state dict is a part of the whole one.
The input enters through `copy_to_model` and the (L / M, B, P) output
leaves through `gather_from_model` along the heads; where M does not
divide L every rank keeps every head.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sm3x_torch.models.layers import BatchNorm
from sm3x_torch.parallel.tensor import copy_to_model, gather_from_model


def _linear(fan_in: int, out: int, bias: bool = False) -> nn.Linear:
    """Linear with torch.nn.Linear's U(+-1/sqrt(fan_in)) init of weight and
    bias, the JAX package's `torch_linear_init`."""
    lin = nn.Linear(fan_in, out, bias=bias)
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(lin.weight, -bound, bound)
    if bias:
        nn.init.uniform_(lin.bias, -bound, bound)
    return lin


class SSLProjector(nn.Sequential):
    def __init__(self, in_dim: int, proj_dim: int):
        super().__init__(
            _linear(in_dim, in_dim), BatchNorm(in_dim), nn.ReLU(inplace=True),
            _linear(in_dim, in_dim), BatchNorm(in_dim), nn.ReLU(inplace=True),
            _linear(in_dim, proj_dim), BatchNorm(proj_dim, affine=False))


def _ProjHead(in_dim: int, proj_dim: int, variant: str) -> nn.Sequential:
    """One label's head; `variant` picks the reference's v1..v4 stack."""
    bn_relu = lambda: (BatchNorm(in_dim), nn.ReLU(inplace=True))
    last_bn = BatchNorm(proj_dim, affine=False)
    if variant == "v1":
        return SSLProjector(in_dim, proj_dim)
    if variant == "v2":
        return nn.Sequential(_linear(in_dim, in_dim), *bn_relu(),
                             _linear(in_dim, proj_dim), last_bn)
    if variant == "v3":
        return nn.Sequential(_linear(in_dim, proj_dim), last_bn)
    if variant == "v4":
        return nn.Sequential(_linear(in_dim, proj_dim, bias=True))
    raise ValueError(f"unknown projector variant {variant!r}")


class MultiLabelProjector(nn.Module):
    """`num_labels` parallel heads: (B, in_dim) -> (H, B, proj_dim)."""

    tp_kind = "labels"   # sm3x_torch.parallel.tensor.tensor_parallel

    def __init__(self, in_dim: int, proj_dim: int, num_labels: int = 8,
                 variant: str = "v4"):
        super().__init__()
        self.variant = variant
        self.projectors = nn.ModuleList(
            [] if variant == "v0" else
            [_ProjHead(in_dim, proj_dim, variant) for _ in range(num_labels)])
        self.group = None   # the model group once the heads are split

    def split_for_model(self, size: int, index: int, group) -> None:
        """Keep heads [index L / size, (index + 1) L / size), by their
        global index; all of them where `size` does not divide L."""
        n = len(self.projectors)
        if n == 0 or n % size:
            return
        per = n // size
        self.projectors = nn.ModuleDict(
            (str(h), self.projectors[h])
            for h in range(index * per, (index + 1) * per))
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.variant == "v0":
            return x[None]  # nn.Identity: a single pseudo-head
        if self.group is not None:
            x = copy_to_model(x, self.group)
        # the same layer of every head this rank holds
        for layers in zip(*self.projectors.children()):
            first = layers[0]
            if isinstance(first, nn.Linear):
                # (B, in) or (H, B, in) by (H, in, out): one batched product
                x = x @ torch.stack([l.weight for l in layers]).transpose(1, 2)
                if first.bias is not None:
                    x = x + torch.stack([l.bias for l in layers])[:, None]
            elif isinstance(first, BatchNorm):
                x = torch.stack([l(x[h]) for h, l in enumerate(layers)])
            else:
                x = torch.relu(x)
        if self.group is not None:
            x = gather_from_model(x, 0, self.group)
        return x
