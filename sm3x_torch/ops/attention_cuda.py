"""Flash-attention kernels K3f, K3b-dq and K3b-dkv
(sm3x_torch/csrc/flash_attention.cu): the wrappers that check their inputs,
allocate the outputs and launch them on PyTorch's current stream.

Counterpart of the TPU flash attention that sm3x/models/vit.py:61-87 calls
(JAX's Pallas library kernel: forward and the dkv / dq backward kernels).
Tensors are in the Flax layout (B, S, H, D), read through their strides
with the head dim contiguous; D must be 64, the head width of every ViT of
the repo. float32 and bfloat16 inputs. The forward computes in float32.
The backward picks its kernels by dtype: float32 inputs run the FMA kernels
of flash_attention.cu (float32 arithmetic on the CUDA cores), bf16 inputs
the tensor-core kernels of flash_attention_bwd_mma.cu (bf16 operands,
float32 sums, as the TPU kernel), which read 16-byte row starts: a bf16
tensor whose data pointer or (b, s, h) strides are not 16-byte multiples
raises ValueError.

Each wrapper takes CUDA tensors only and counts its launches in
`<wrapper>.launches`; the backward wrappers also count them by kernel in
`<wrapper>.variants` ("fma" float32, "mma" bf16). The plain versions and
the autograd Function that picks between kernels and plain versions by
device are in sm3x_torch/ops/attention.py.
"""

from __future__ import annotations

import ctypes

import torch

from sm3x_torch.ops import _native

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(name: str, *tensors: torch.Tensor) -> None:
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} takes CUDA tensors")
        if t.dim() != 4 or t.shape != first.shape:
            raise ValueError(f"{name}: every tensor must be (B, S, H, D) of "
                             f"one shape, got {[tuple(x.shape) for x in tensors]}")
        if t.dtype != first.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name}: float32 or bfloat16 tensors of one "
                             f"dtype, got {[x.dtype for x in tensors]}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on different devices")
    b, s, h, d = first.shape
    if d != HEAD_DIM or min(b, s, h) < 1:
        raise ValueError(f"{name}: head dim {d}; the kernels take D = "
                         f"{HEAD_DIM} and non-empty B, S, H")


def _check_rows_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The bf16 backward kernels copy rows with cp.async and read them with
    ldmatrix, 16 bytes at a time."""
    if tensors[0].dtype != torch.bfloat16:
        return
    for t in tensors:
        strides = [st for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st % 8 for st in strides):
            raise ValueError(
                f"{name}: bf16 rows must start on 16-byte boundaries (data "
                f"pointer and (b, s, h) strides multiples of 8 elements), "
                f"got pointer % 16 = {t.data_ptr() % 16}, strides "
                f"{t.stride()}")


def _count(fn, q: torch.Tensor) -> None:
    fn.launches += 1
    fn.variants["mma" if q.dtype == torch.bfloat16 else "fma"] += 1


def _rowstats(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    b, s, h, _ = q.shape
    if (t.shape != (b, h, s) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != q.device):
        raise ValueError(f"{name}: per-row statistics must be a contiguous "
                         f"float32 (B, H, S) tensor on the inputs' device")


def _call(fn, name: str, tensors, strided, q: torch.Tensor,
          scale: float) -> None:
    """`tensors`: data pointers in the kernel's order; `strided`: the
    (B, S, H, D) tensors whose (b, s, h) strides the kernel reads."""
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    vals = [st for t in strided for st in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(vals))(*vals)
    b, s, h, d = q.shape
    _native.check(fn(ctypes.addressof(ptrs), ctypes.addressof(strides), b, s,
                     h, d, float(scale), _DTYPES[q.dtype],
                     _native.stream_handle(q.device)), name)


def flash_forward_cuda(q, k, v, scale: float):
    """K3f: (out (B, S, H, D) in the inputs' dtype, lse (B, H, S) float32)."""
    _check("flash_forward_cuda", q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    lib = _native.library()
    flash_forward_cuda.launches += 1
    _call(lib.sm3x_flash_fwd, "sm3x_flash_fwd", (q, k, v, out, lse),
          (q, k, v, out), q, scale)
    return out, lse


flash_forward_cuda.launches = 0


def flash_backward_dq_cuda(q, k, v, out, dout, lse, scale: float):
    """K3b-dq: (dq, delta) with delta = rowsum(dout * out) (B, H, S) float32,
    which K3b-dkv reads."""
    _check("flash_backward_dq_cuda", q, k, v, out, dout)
    _check_rows_aligned("flash_backward_dq_cuda", q, k, v, out, dout)
    _rowstats("flash_backward_dq_cuda", lse, q)
    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    delta = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    lib = _native.library()
    _count(flash_backward_dq_cuda, q)
    _call(lib.sm3x_flash_bwd_dq, "sm3x_flash_bwd_dq",
          (q, k, v, out, dout, lse, delta, dq), (q, k, v, out, dout, dq), q,
          scale)
    return dq, delta


flash_backward_dq_cuda.launches = 0
flash_backward_dq_cuda.variants = {"fma": 0, "mma": 0}


def flash_backward_dkv_cuda(q, k, v, dout, lse, delta, scale: float):
    """K3b-dkv: (dk, dv), from the lse of the forward and the delta of
    K3b-dq."""
    _check("flash_backward_dkv_cuda", q, k, v, dout)
    _check_rows_aligned("flash_backward_dkv_cuda", q, k, v, dout)
    _rowstats("flash_backward_dkv_cuda", lse, q)
    _rowstats("flash_backward_dkv_cuda", delta, q)
    b, s, h, d = q.shape
    dk = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    dv = torch.empty_like(dk)
    lib = _native.library()
    _count(flash_backward_dkv_cuda, q)
    # the kernel does not read o: q stands in for its pointer and strides
    _call(lib.sm3x_flash_bwd_dkv, "sm3x_flash_bwd_dkv",
          (q, k, v, q, dout, lse, delta, dk, dv), (q, k, v, q, dout, dk), q,
          scale)
    return dk, dv


flash_backward_dkv_cuda.launches = 0
flash_backward_dkv_cuda.variants = {"fma": 0, "mma": 0}
