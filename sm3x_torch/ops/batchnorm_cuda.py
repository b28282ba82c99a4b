"""Batch norm in train mode with a residual add and a ReLU folded in, kernel
K6 (sm3x_torch/csrc/batchnorm.cu): the wrappers that check their inputs,
plan the tiles, allocate the outputs and scratch and launch the kernels on
PyTorch's current stream; the autograd Function over them; and the plain
twin, which the CPU takes.

    y = relu?(batch_norm(x) (+ residual))

normalises each channel of x with the batch mean and the biased batch
variance and moves the running statistics in the JAX package's (Flax)
convention: `running_mean` and `running_var` toward the batch mean and the
*biased* variance, momentum 0.1, eps 1e-5, and `num_batches_tracked` by
one (sm3x_torch.models.layers). With `update=False` (the second forward of
a recomputed block) nothing but y is written.

K6 takes CUDA activations (N, C, H, W) that are channels-last contiguous,
bfloat16 or float32, C a multiple of 8, 16-byte aligned, with float32
per-channel tensors (`kernel_takes`); the residual, where there is one,
likewise. K6 replaces no TPU kernel: the JAX package leaves batch norm to
XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from sm3x_torch.ops import _native

MOMENTUM = 0.1  # torch convention; Flax momentum 0.9
EPS = 1e-5

SMS = 132                 # the H100's streaming multiprocessors
THREADS, UNROLL = 256, 4  # kThreads, kUnroll in csrc/batchnorm.cu
MAX_COLUMNS = 1024        # kMaxColumns
# a column's threads along C at most: 128 bytes of a row, a whole line; so
# the channels are split into more columns, each merged by its own last
# block (32 at C = 2048 in bf16), which keeps those merges short
MAX_TC_LOG2 = 3
# the reductions' registers (92-124 a thread) hold two blocks an SM
REDUCE_BLOCKS_PER_SM = 2
MASK_NONE, MASK_FROM_X, MASK_FROM_Y = 0, 1, 2   # the backward's ReLU mask
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def plan(rows: int, channels: int, itemsize: int) -> tuple:
    """(chunks, tc_log2, columns, blocks) of an (rows, channels) activation
    of `itemsize` bytes a value: the 16-byte chunks of a row, log2 of the
    threads along C (a power of two up to 1 << MAX_TC_LOG2, at most the
    chunks), the columns of channel tiles, and the blocks a column of the
    two reductions, enough for REDUCE_BLOCKS_PER_SM blocks on every SM and
    at most one a row tile. On an H100 at ResNet-50's 53 shapes (batch 96,
    224, bf16) this plan's K6 took 33.96 ms a step of kernels, against
    36.10-44.05 with up to 32 or 4 threads along C and 1 or 4 blocks an
    SM."""
    chunks = channels * itemsize // 16
    tc_log2 = min(MAX_TC_LOG2, chunks.bit_length() - 1)
    columns = -(-chunks >> tc_log2)
    tile_rows = (THREADS >> tc_log2) * UNROLL
    tiles = -(-rows // tile_rows)
    blocks = max(1, min(tiles, -(-REDUCE_BLOCKS_PER_SM * SMS // columns)))
    return chunks, tc_log2, columns, blocks


def _per_channel(t, c: int, device) -> bool:
    return t is None or (t.device == device and t.dtype == torch.float32
                         and t.is_contiguous() and t.numel() == c)


def _activation(t, x) -> bool:
    return (t.device == x.device and t.dtype == x.dtype
            and t.shape == x.shape and t.data_ptr() % 16 == 0
            and t.is_contiguous(memory_format=torch.channels_last))


def kernel_takes(x: torch.Tensor, residual=None, *per_channel) -> bool:
    """Whether K6 takes x: a CUDA (N, C, H, W) tensor, channels-last
    contiguous, bfloat16 or float32, C a multiple of 8 and 16-byte aligned;
    `residual` (or None) of x's shape, dtype and layout; each of
    `per_channel` (or None) float32, contiguous, C long, on x's device."""
    if not (x.is_cuda and x.dim() == 4 and x.dtype in _BF16
            and x.shape[1] % 8 == 0 and x.numel() > 0
            and x.shape[1] * x.element_size()
            <= 16 * MAX_COLUMNS << MAX_TC_LOG2
            and x.numel() // x.shape[1] < 2 ** 31 and _activation(x, x)):
        return False
    if residual is not None and not _activation(residual, x):
        return False
    return all(_per_channel(t, x.shape[1], x.device) for t in per_channel)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def bn_forward_cuda(x, weight, bias, running_mean, running_var, steps,
                    residual=None, relu=False):
    """K6's forward (statistics, then apply): (y, mean, invstd), the last two
    float32 (C,). `running_mean`, `running_var` and `steps` (int64) move,
    unless all three are None."""
    if not kernel_takes(x, residual, weight, bias, running_mean, running_var):
        raise ValueError(
            f"bn_forward_cuda takes a channels-last CUDA (N, C, H, W) tensor of "
            f"bfloat16 or float32 with C % 8 == 0 and float32 per-channel "
            f"tensors, got {tuple(x.shape)} {x.dtype} on {x.device}")
    if (running_mean is None) != (steps is None) or (
            running_mean is None) != (running_var is None):
        raise ValueError("bn_forward_cuda: the running statistics and the "
                         "step count move together or not at all")
    if steps is not None and (steps.dtype != torch.long
                              or steps.device != x.device):
        raise ValueError("bn_forward_cuda: steps must be int64 on x's device")
    c = x.shape[1]
    rows = x.numel() // c
    chunks, tc_log2, columns, blocks = plan(rows, c, x.element_size())
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = torch.empty((2, c), device=x.device, dtype=torch.float32)
    part = torch.empty(blocks * (2 * c + columns), device=x.device,
                       dtype=torch.float32)
    lib = _native.library()
    _native.check(lib.sm3x_bn_fwd(
        x.data_ptr(), _ptr(residual), y.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), _ptr(weight), _ptr(bias), _ptr(running_mean),
        _ptr(running_var), _ptr(steps), part.data_ptr(), rows, chunks, tc_log2,
        columns, blocks, _BF16[x.dtype], int(relu), MOMENTUM, EPS,
        _native.stream_handle(x.device)), "sm3x_bn_fwd")
    return y, stats[0], stats[1]


def bn_backward_cuda(dy, x, y, weight, bias, mean, invstd, mask: int,
                     need_dx: bool = True, need_dres: bool = False):
    """K6's backward (reduce, then elemt unless `need_dx` is False):
    (dx, d_residual, dgamma, dbeta). `mask` says where the ReLU's mask
    comes from: MASK_NONE (no ReLU), MASK_FROM_X (recomputed from x and the
    parameters) or MASK_FROM_Y (read from the forward's output y). Where
    `need_dres` (a ReLU), d_residual is dy masked; else None. dgamma and
    dbeta are None without a weight."""
    if not (kernel_takes(x, dy, weight, bias, mean, invstd)
            and (y is None or _activation(y, x))):
        raise ValueError(
            f"bn_backward_cuda takes channels-last CUDA dy, x (and y) of one "
            f"shape and dtype and float32 per-channel tensors, got "
            f"{tuple(x.shape)} {x.dtype}, dy {tuple(dy.shape)} {dy.dtype}")
    if mask not in (MASK_NONE, MASK_FROM_X, MASK_FROM_Y) or (
            mask == MASK_FROM_Y and y is None) or (
            need_dres and (mask == MASK_NONE or not need_dx)):
        raise ValueError(f"bn_backward_cuda: mask {mask} with y "
                         f"{'absent' if y is None else 'given'}, need_dres "
                         f"{need_dres}, need_dx {need_dx}")
    c = x.shape[1]
    rows = x.numel() // c
    chunks, tc_log2, columns, blocks = plan(rows, c, x.element_size())
    sums = torch.empty(2 * c, device=x.device, dtype=torch.float32)
    part = torch.empty(2 * blocks * c, device=x.device, dtype=torch.float32)
    grads = (torch.empty((2, c), device=x.device, dtype=torch.float32)
             if weight is not None else None)
    dx = (torch.empty_like(x, memory_format=torch.channels_last)
          if need_dx else None)
    dres = (torch.empty_like(x, memory_format=torch.channels_last)
            if need_dres else None)
    lib = _native.library()
    _native.check(lib.sm3x_bn_bwd(
        dy.data_ptr(), x.data_ptr(), _ptr(y), mean.data_ptr(),
        invstd.data_ptr(), _ptr(weight), _ptr(bias), sums.data_ptr(),
        0 if grads is None else grads[0].data_ptr(),
        0 if grads is None else grads[1].data_ptr(), _ptr(dx), _ptr(dres),
        part.data_ptr(), rows, chunks, tc_log2, columns, blocks,
        _BF16[x.dtype], mask, _native.stream_handle(x.device)), "sm3x_bn_bwd")
    if grads is None:
        return dx, dres, None, None
    return dx, dres, grads[0], grads[1]


class BatchNormAct(torch.autograd.Function):
    """relu?(batch_norm(x) (+ residual)) on K6, forward and backward. Saves
    x, the batch statistics and, with both a ReLU and a residual, y (the
    next block's input, kept by its convolution anyway)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                steps, relu):
        y, mean, invstd = bn_forward_cuda(x, weight, bias, running_mean,
                                          running_var, steps, residual, relu)
        ctx.mask = (MASK_NONE if not relu else
                    MASK_FROM_Y if residual is not None else MASK_FROM_X)
        ctx.save_for_backward(x, weight, bias, mean, invstd,
                              y if ctx.mask == MASK_FROM_Y else None)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, mean, invstd, y = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        dy = dy.contiguous(memory_format=torch.channels_last)
        need_dres = need_r and ctx.mask != MASK_NONE
        dx, dres, dw, db = bn_backward_cuda(
            dy, x, y, weight, bias, mean, invstd, ctx.mask,
            need_dx=need_x or need_dres, need_dres=need_dres)
        if need_r and not need_dres:
            dres = dy   # no ReLU: the residual's gradient is dy itself
        return (dx if need_x else None, dw if need_w else None,
                db if need_b else None, dres if need_r else None,
                None, None, None, None)


def epilogue(y: torch.Tensor, residual=None, relu: bool = True):
    """The plain composition's tail: + residual, then ReLU in place."""
    if residual is not None:
        y = y + residual
    return torch.relu_(y) if relu else y


def batch_norm_act_plain(x, weight, bias, running_mean, running_var, steps,
                         residual=None, relu=True, update=True):
    """K6's plain twin: `F.batch_norm` in train mode, the running variance
    corrected to Flax's biased one, then + residual and ReLU.

    With m = MOMENTUM torch stores v' = (1 - m) v + m s n / (n - 1), where s
    is the biased variance and n counts the values per channel; Flax wants
    (1 - m) v + m s = (1 - m) v / n + v' (n - 1) / n. Both terms are
    positive, so the correction loses no precision."""
    n = x.numel() // x.shape[1]
    var_before = running_var.clone()
    if not update:
        # the same call on copies: the same tensors saved for the backward,
        # nothing moved
        y = F.batch_norm(x, running_mean.clone(), var_before, weight, bias,
                         True, MOMENTUM, EPS)
        return epilogue(y, residual, relu)
    y = F.batch_norm(x, running_mean, running_var, weight, bias, True,
                     MOMENTUM, EPS)
    # `.data`: autograd keeps running_var for the backward (which reads it
    # only in eval mode); an in-place update of the tensor itself would fail
    # autograd's version check
    running_var.data.mul_((n - 1) / n).add_(var_before,
                                            alpha=(1.0 - MOMENTUM) / n)
    steps.add_(1)
    return epilogue(y, residual, relu)


def batch_norm_act(x, weight, bias, running_mean, running_var, steps,
                   residual=None, relu=True, update=True):
    """relu?(batch_norm(x) (+ residual)) in train mode: K6 for a CUDA x (which
    must be one `kernel_takes`), the plain twin for a CPU x."""
    if not x.is_cuda:
        return batch_norm_act_plain(x, weight, bias, running_mean,
                                    running_var, steps, residual, relu,
                                    update)
    moving = (running_mean, running_var, steps) if update else (None,) * 3
    return BatchNormAct.apply(x, weight, bias, residual, *moving, relu)
