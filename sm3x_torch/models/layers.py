"""Batch normalisation with the JAX package's (Flax) running statistics.

Flax's BatchNorm (momentum 0.9, eps 1e-5) normalises with the batch mean and
the *biased* batch variance, and moves `running_var` toward that same biased
variance (flax 0.12 `_compute_stats`: mean(|x - mu|^2)). `torch.nn.BatchNorm*`
normalises the same way but moves `running_var` toward the *unbiased*
variance, larger by n / (n - 1) where n counts the values per channel. For
the projector BNs n is B or 2B, so at B = 48 the two differ by 2%.

This module keeps torch's fused batch-norm for the forward and corrects the
running variance after it, per channel, from the buffer before and after:
with m = 0.1 torch stores v' = (1 - m) v + m s n / (n - 1), where s is the
biased variance; Flax wants (1 - m) v + m s = (1 - m) v / n + v' (n - 1) / n.
Both terms are positive, so the correction loses no precision. The state
dict keys are torch's (`weight`, `bias`, `running_mean`, `running_var`,
`num_batches_tracked`), as the exported checkpoints name them.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM = 0.1  # torch convention; Flax momentum 0.9
EPS = 1e-5

_state = threading.local()


@contextlib.contextmanager
def recomputing():
    """Inside the block a train-mode `BatchNorm` normalises with the batch
    statistics as always and leaves its running statistics and its step
    count alone: for the second forward of a checkpointed block, which the
    backward runs on a batch the statistics have already taken in."""
    before = getattr(_state, "recomputing", False)
    _state.recomputing = True
    try:
        yield
    finally:
        _state.recomputing = before


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1 of (N, C) or (N, C, H, W) inputs."""

    def __init__(self, num_features: int, affine: bool = True):
        super().__init__()
        self.num_features = num_features
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, MOMENTUM, EPS)
        n = x.numel() // x.shape[1]
        if n < 2:
            raise ValueError(f"BatchNorm in train mode needs more than one "
                             f"value per channel, got input {tuple(x.shape)}")
        var_before = self.running_var.clone()
        if getattr(_state, "recomputing", False):
            # the same call on copies: the same tensors saved for the
            # backward, nothing moved
            return F.batch_norm(x, self.running_mean.clone(), var_before,
                                self.weight, self.bias, True, MOMENTUM, EPS)
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                         self.bias, True, MOMENTUM, EPS)
        # `.data`: autograd keeps running_var for the backward (which reads it
        # only in eval mode); an in-place update of the tensor itself would
        # fail autograd's version check
        self.running_var.data.mul_((n - 1) / n).add_(
            var_before, alpha=(1.0 - MOMENTUM) / n)
        self.num_batches_tracked.add_(1)
        return y

    def extra_repr(self) -> str:
        return f"{self.num_features}, affine={self.affine}"
