"""Batch normalisation with the JAX package's (Flax) running statistics; and
the dormant weight-standardised convolutions and group norm of
sm3x/models/layers.py (`ConvWS` :14, `ConvAWS` :50, `group_norm` :88),
which no model of either package builds.

Flax's BatchNorm (momentum 0.9, eps 1e-5) normalises with the batch mean and
the *biased* batch variance, and moves `running_var` toward that same biased
variance (flax 0.12 `_compute_stats`: mean(|x - mu|^2)). `torch.nn.BatchNorm*`
normalises the same way but moves `running_var` toward the *unbiased*
variance, larger by n / (n - 1) where n counts the values per channel. For
the projector BNs n is B or 2B, so at B = 48 the two differ by 2%.

`batch_norm_act` is a BatchNorm's forward with a residual add and a ReLU
after it (`BatchNorm.forward` is its case without either). In train mode
on one process it takes kernel K6 (sm3x_torch.ops.batchnorm_cuda), which
folds the add and the ReLU into its apply pass, where the input is one K6
takes: a CUDA (N, C, H, W) tensor, channels-last contiguous, bfloat16 or
float32, C a multiple of 8 (`kernel_takes`). Every other input keeps
torch's fused batch-norm, then the add and the ReLU: on the CPU through
K6's plain twin, which corrects the running variance after it, per
channel, from the buffer before and after
(`batchnorm_cuda.batch_norm_act_plain`). Each call counts
`model.bn_kernel` or `model.bn_library` (sm3x_torch.utils.profiling). The
state dict keys are torch's (`weight`, `bias`, `running_mean`,
`running_var`, `num_batches_tracked`), as the exported checkpoints name
them.

Under a process group (sm3x_torch.parallel) a train-mode `BatchNorm`
normalises with the statistics of the global batch, as the JAX package's
GSPMD step does over its data axis (the ranks of the run's data group,
sm3x_torch.core.mesh.data_group: the whole run with --mesh-model 1), and
the running statistics move toward the global mean and the biased global
variance, the same on every rank (`torch.nn.SyncBatchNorm` would move
`running_var` toward the unbiased variance). On CUDA tensors it runs PyTorch's own batch-norm
kernels: each rank's mean and inverse deviation (`batch_norm_stats`,
float32), one all-gather of them with the counts, their combination, the
normalisation; the backward's two per-channel sums go through one
all-reduce (as in SyncBatchNorm). On the CPU, its plain twin: each rank's
mean, one all-reduce of the counted means, then one of the counted
variances about the global mean, both differentiable.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from sm3x_torch.core.mesh import data_group
from sm3x_torch.ops import batchnorm_cuda
from sm3x_torch.ops.batchnorm_cuda import EPS, MOMENTUM
from sm3x_torch.parallel.collectives import (all_reduce_sum, gather_rows,
                                             is_distributed)
from sm3x_torch.utils.profiling import count

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
        return batch_norm_act(self, x, relu=False)

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode under a process group: normalise with the global
        batch's mean and biased variance; move the running statistics
        toward them (not inside `recomputing()`)."""
        if x.is_cuda:
            y, mean, invstd = _GlobalBatchNormCuda.apply(x, self.weight,
                                                         self.bias)
            var = invstd.pow(-2) - EPS
        else:
            y, mean, var = _global_batch_norm_plain(x, self.weight, self.bias)
        if not getattr(_state, "recomputing", False):
            with torch.no_grad():
                self.running_mean.mul_(1.0 - MOMENTUM).add_(
                    mean.detach(), alpha=MOMENTUM)
                self.running_var.mul_(1.0 - MOMENTUM).add_(
                    var.detach(), alpha=MOMENTUM)
                self.num_batches_tracked.add_(1)
        return y

    def extra_repr(self) -> str:
        return f"{self.num_features}, affine={self.affine}"


def batch_norm_act(bn: BatchNorm, x: torch.Tensor, residual=None,
                   relu: bool = True) -> torch.Tensor:
    """bn(x), then + `residual`, then ReLU: in one K6 call where `bn` is in
    train mode on one process and K6 takes x and the residual; else bn's
    batch norm (eval mode: the running statistics; under a process group:
    the global batch's; otherwise torch's) followed by the add and ReLU."""
    if bn.training and not is_distributed():
        n = x.numel() // x.shape[1]
        if n < 2:
            raise ValueError(f"BatchNorm in train mode needs more than one "
                             f"value per channel, got input {tuple(x.shape)}")
        args = (x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                bn.num_batches_tracked, residual, relu,
                not getattr(_state, "recomputing", False))
        if batchnorm_cuda.kernel_takes(x, residual, bn.weight, bn.bias,
                                       bn.running_mean, bn.running_var):
            count("model.bn_kernel")
            return batchnorm_cuda.batch_norm_act(*args)
        count("model.bn_library")
        return batchnorm_cuda.batch_norm_act_plain(*args)
    count("model.bn_library")
    if bn.training:
        y = bn._global_batch_forward(x)
    else:
        y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, MOMENTUM, EPS)
    return batchnorm_cuda.epilogue(y, residual, relu)


def _global_batch_norm_plain(x, weight, bias):
    """(y, global mean, global biased variance) from this rank's rows:
    one all-reduce of the counted means, one of the counted variances
    about the global mean (float32, or float64 for a float64 input)."""
    c = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    shape = (1, c) + (1,) * (x.dim() - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    n = x.numel() // c
    group = data_group()
    counted = all_reduce_sum(torch.cat([xf.mean(dims) * n,
                                        xf.new_full((1,), n)]), group)
    total = counted[c]
    mean = counted[:c] / total
    centred = xf - mean.view(shape)
    var = all_reduce_sum((centred * centred).sum(dims), group) / total
    y = centred * torch.rsqrt(var + EPS).view(shape)
    if weight is not None:
        y = y * weight.view(shape) + bias.view(shape)
    return y.to(x.dtype), mean, var


class _GlobalBatchNormCuda(torch.autograd.Function):
    """SyncBatchNorm's arithmetic on PyTorch's batch-norm kernels, without
    its running-statistics update: forward (y, mean, invstd) of the
    global batch, backward through one all-reduce of the two sums."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        if not (x.is_contiguous()
                or x.is_contiguous(memory_format=torch.channels_last)):
            x = x.contiguous()
        c = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, EPS)
        count = mean.new_full((1,), x.numel() // c)
        every = gather_rows(torch.cat([mean, invstd, count])[None],
                            data_group())
        counts = every[:, 2 * c].contiguous()
        # running statistics of its own that the kernel moves by momentum 0
        # (without them it wants the counts in the input's dtype, which
        # bf16 cannot hold exactly)
        scratch = mean.new_zeros(2, c)
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, every[:, :c].contiguous(), every[:, c:2 * c].contiguous(),
            scratch[0], scratch[1], 0.0, EPS, counts)
        y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, EPS)
        ctx.save_for_backward(x, weight, mean, invstd,
                              counts.to(torch.int32))
        ctx.mark_non_differentiable(mean, invstd)
        return y, mean, invstd

    @staticmethod
    def backward(ctx, gy, _mean, _invstd):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        fmt = (torch.channels_last
               if x.dim() == 4 and x.is_contiguous(
                   memory_format=torch.channels_last)
               else torch.contiguous_format)
        gy = gy.contiguous(memory_format=fmt)
        need_x, need_w, need_b = ctx.needs_input_grad
        sum_dy, sum_dy_xmu, gw, gb = torch.batch_norm_backward_reduce(
            gy, x, mean, invstd, weight, need_x,
            weight is not None and need_w, weight is not None and need_b)
        gx = None
        if need_x:
            c = x.shape[1]
            sums = all_reduce_sum(torch.cat([sum_dy, sum_dy_xmu]),
                                  data_group())
            gx = torch.batch_norm_backward_elemt(
                gy, x, mean, invstd, weight, sums[:c], sums[c:], counts)
        return gx, gw if need_w else None, gb if need_b else None


# ----------------------------------------------------------------------------
# Weight-standardised convolutions and group norm (dormant in the reference)
# ----------------------------------------------------------------------------

class ConvWS(nn.Module):
    """Conv2d over NCHW whose kernel is standardised per output channel
    before use: (w - mean) / (std + eps) over (in, kh, kw), with the biased
    std (`jnp.std`'s). The weight is OIHW (Flax keeps HWIO); He-normal over
    fan-out, as Flax's variance_scaling(2, fan_out, normal); the bias 0.
    Padding kh // 2, kw // 2."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3),
                 strides: int = 1, use_bias: bool = True, eps: float = 1e-5):
        super().__init__()
        self.strides, self.eps = strides, eps
        self.weight = nn.Parameter(torch.empty(features, in_channels,
                                               *kernel))
        nn.init.kaiming_normal_(self.weight, mode="fan_out",
                                nonlinearity="relu")
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def standardised(self) -> torch.Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
        return (w - mean) / (std + self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.weight.shape[2:]
        return F.conv2d(x, self.standardised().to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype),
                        stride=self.strides, padding=(kh // 2, kw // 2))


class ConvAWS(ConvWS):
    """Adaptive weight standardisation: a learned per-output-channel scale
    `ws_gamma` (1) and shift `ws_beta` (0), (O, 1, 1, 1), applied to the
    standardised kernel."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3),
                 strides: int = 1, use_bias: bool = True, eps: float = 1e-5):
        super().__init__(in_channels, features, kernel, strides, use_bias,
                         eps)
        self.ws_gamma = nn.Parameter(torch.ones(features, 1, 1, 1))
        self.ws_beta = nn.Parameter(torch.zeros(features, 1, 1, 1))

    def standardised(self) -> torch.Tensor:
        return super().standardised() * self.ws_gamma + self.ws_beta


def group_norm(num_channels: int, num_groups: int = 32, eps: float = 1e-6,
               affine: bool = True) -> nn.GroupNorm:
    """The reference's GroupNorm helper, at Flax's defaults (eps 1e-6, 32
    groups), over channel dim 1."""
    return nn.GroupNorm(num_groups, num_channels, eps=eps, affine=affine)
