"""The sparse-expert layer's token moves, kernel K5
(sm3x_torch/csrc/moe_dispatch.cu): the wrappers that check their inputs,
allocate the outputs and launch the four kernels on PyTorch's current
stream.

K5 replaces no TPU kernel (the JAX package has no expert layer); it carries
V-MoE's dispatch and combine (sm3x_torch.ops.moe) on the card. Rows are
float32 or bfloat16, contiguous, D * itemsize a multiple of 16 bytes and
16-byte aligned; the slot map is int32 (`token_slot` (N, k), `slot_assign`
(S,)), the gates float32 (N, k). Each wrapper takes CUDA tensors only and
counts its launches in `<wrapper>.launches`. The plain versions and the
autograd Functions that pick between kernels and plain versions by device
are in sm3x_torch/ops/moe.py.
"""

from __future__ import annotations

import torch

from sm3x_torch.ops import _native

MAX_CHOICES = 4   # kMaxChoices in csrc/moe_dispatch.cu
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def _rows(name: str, *rows: torch.Tensor) -> int:
    """The 16-byte pieces of a row of `rows`, after the checks."""
    first = rows[0]
    for t in rows:
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{name} takes CUDA tensors on one device")
        if t.dim() != 2 or t.shape[1] != first.shape[1]:
            raise ValueError(f"{name}: rows must be 2-D of one width, got "
                             f"{[tuple(x.shape) for x in rows]}")
        if t.dtype != first.dtype or t.dtype not in _BF16:
            raise ValueError(f"{name}: float32 or bfloat16 rows of one "
                             f"dtype, got {[x.dtype for x in rows]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                             f"aligned")
    width = first.shape[1] * first.element_size()
    if width % 16 or width == 0:
        raise ValueError(f"{name}: a row of {width} bytes is not a multiple "
                         f"of 16")
    return width // 16


def _maps(name: str, device, *maps: torch.Tensor) -> None:
    for m in maps:
        if (m.device != device or not m.is_contiguous()
                or m.dtype not in (torch.int32, torch.float32)):
            raise ValueError(f"{name}: maps must be contiguous int32 and "
                             f"gates float32 on the rows' device")


def _choices(name: str, token_slot: torch.Tensor) -> int:
    k = token_slot.shape[1]
    if token_slot.dtype != torch.int32 or not 1 <= k <= MAX_CHOICES:
        raise ValueError(f"{name}: token_slot (N, k) int32 with k <= "
                         f"{MAX_CHOICES}, got {tuple(token_slot.shape)} "
                         f"{token_slot.dtype}")
    return k


def moe_dispatch_cuda(x: torch.Tensor, slot_assign: torch.Tensor,
                      k: int) -> torch.Tensor:
    """K5 dispatch forward: (S, D) slot rows, slot s the row of token
    slot_assign[s] // k, zeros where slot_assign[s] < 0."""
    pieces = _rows("moe_dispatch_cuda", x)
    _maps("moe_dispatch_cuda", x.device, slot_assign)
    out = torch.empty((slot_assign.shape[0], x.shape[1]), device=x.device,
                      dtype=x.dtype)
    lib = _native.library()
    moe_dispatch_cuda.launches += 1
    _native.check(lib.sm3x_moe_dispatch_fwd(
        x.data_ptr(), slot_assign.data_ptr(), out.data_ptr(),
        slot_assign.shape[0], k, pieces, _native.stream_handle(x.device)),
        "sm3x_moe_dispatch_fwd")
    return out


moe_dispatch_cuda.launches = 0


def moe_combine_cuda(y: torch.Tensor, gates: torch.Tensor,
                     token_slot: torch.Tensor) -> torch.Tensor:
    """K5 combine forward: (N, D), row t the gate-weighted sum of its
    choices' slot rows (float32 sums, one rounding)."""
    pieces = _rows("moe_combine_cuda", y)
    k = _choices("moe_combine_cuda", token_slot)
    _maps("moe_combine_cuda", y.device, gates, token_slot)
    n = token_slot.shape[0]
    out = torch.empty((n, y.shape[1]), device=y.device, dtype=y.dtype)
    lib = _native.library()
    moe_combine_cuda.launches += 1
    _native.check(lib.sm3x_moe_combine_fwd(
        y.data_ptr(), gates.data_ptr(), token_slot.data_ptr(),
        out.data_ptr(), n, k, pieces, _BF16[y.dtype],
        _native.stream_handle(y.device)), "sm3x_moe_combine_fwd")
    return out


moe_combine_cuda.launches = 0


def moe_combine_backward_cuda(dout: torch.Tensor, y: torch.Tensor,
                              gates: torch.Tensor, slot_assign: torch.Tensor,
                              k: int) -> tuple:
    """K5 combine backward: (dy (S, D), dgates (N, k) float32)."""
    pieces = _rows("moe_combine_backward_cuda", dout, y)
    _maps("moe_combine_backward_cuda", y.device, gates, slot_assign)
    dy = torch.empty_like(y)
    dgates = torch.zeros_like(gates)   # dropped choices keep 0
    lib = _native.library()
    moe_combine_backward_cuda.launches += 1
    _native.check(lib.sm3x_moe_combine_bwd(
        dout.data_ptr(), y.data_ptr(), gates.data_ptr(),
        slot_assign.data_ptr(), dy.data_ptr(), dgates.data_ptr(),
        y.shape[0], k, pieces, _BF16[y.dtype],
        _native.stream_handle(y.device)), "sm3x_moe_combine_bwd")
    return dy, dgates


moe_combine_backward_cuda.launches = 0


def moe_dispatch_backward_cuda(dslots: torch.Tensor,
                               token_slot: torch.Tensor) -> torch.Tensor:
    """K5 dispatch backward: (N, D), row t the sum of its choices' slot
    gradients."""
    pieces = _rows("moe_dispatch_backward_cuda", dslots)
    k = _choices("moe_dispatch_backward_cuda", token_slot)
    _maps("moe_dispatch_backward_cuda", dslots.device, token_slot)
    n = token_slot.shape[0]
    dx = torch.empty((n, dslots.shape[1]), device=dslots.device,
                     dtype=dslots.dtype)
    lib = _native.library()
    moe_dispatch_backward_cuda.launches += 1
    _native.check(lib.sm3x_moe_dispatch_bwd(
        dslots.data_ptr(), token_slot.data_ptr(), dx.data_ptr(), n, k,
        pieces, _BF16[dslots.dtype], _native.stream_handle(dslots.device)),
        "sm3x_moe_dispatch_bwd")
    return dx


moe_dispatch_backward_cuda.launches = 0
