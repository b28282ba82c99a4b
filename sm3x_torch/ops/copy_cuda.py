"""Identity copy kernel K4 (sm3x_torch/csrc/copy.cu), the device-memory
bandwidth probe of tools/bench_copy_torch.py, and its plain version.

Counterpart of `pallas_copy` in tools/bench_pallas_io.py:44-51. Dispatch is
by the tensor's device and nothing else: `copy` on a CUDA tensor launches
the kernel (or raises), on a CPU tensor it takes `copy_plain`.
"""

from __future__ import annotations

import torch

from sm3x_torch.ops import _native


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def copy_cuda(x: torch.Tensor) -> torch.Tensor:
    """K4: a new contiguous float32 tensor equal to `x`, on the card."""
    if not x.is_cuda:
        raise ValueError("copy_cuda takes a CUDA tensor")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"copy_cuda takes a contiguous float32 tensor, got "
                         f"{x.dtype}, strides {x.stride()}")
    out = torch.empty_like(x)
    lib = _native.library()
    copy_cuda.launches += 1
    _native.check(lib.sm3x_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                _native.stream_handle(x.device)), "sm3x_copy")
    return out


copy_cuda.launches = 0


def copy(x: torch.Tensor) -> torch.Tensor:
    return copy_cuda(x) if x.is_cuda else copy_plain(x)
