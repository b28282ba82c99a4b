"""NT-Xent forward and backward kernels K2f / K2b (sm3x_torch/csrc/ntxent.cu)
with their plain PyTorch twins, and the autograd Function that joins them.

Counterpart of sm3x/ops/ntxent_pallas.py (`_pallas_fwd` :77, `_pallas_bwd`
:91, custom VJP :108-126), with a leading problem axis: ``z: (P, 2b, D)``
gives per-problem losses ``(P,)``, so every term and group of one SSL loss
is one forward and one backward launch.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from sm3x_torch.ops import _native
from sm3x_torch.ops.ntxent import ntxent_problems as ntxent_forward_plain

MAX_DIM = 512  # 32 lanes x 16 registers a row (csrc/ntxent.cu kMaxPerLane)

# K2f's shape (csrc/ntxent.cu): a cluster of CLUSTER blocks a problem, a
# block CHUNK_ROWS of its rows at a time against tiles of the problem's rows
# that are a multiple of COLUMN_BLOCK long (32 lanes x 3 columns)
CLUSTER, CHUNK_ROWS, COLUMN_BLOCK = 8, 12, 96
_FWD_STATIC = 128  # bytes of static shared memory the kernel declares


def ntxent_forward_plan(n: int, d: int, aligned: bool = True) -> dict:
    """How K2f runs an (n, D) problem, from the shape alone: rows a block,
    the padded row stride in floats (the least odd number of 16-byte steps
    with a step of padding: reads down a column hit distinct banks), the
    rows of a tile (the whole problem rounded up to COLUMN_BLOCK where that
    fits in shared memory beside the block's own CHUNK_ROWS rows and every
    row's inverse norm, else the largest multiple of COLUMN_BLOCK that
    does), the number of tiles, the dynamic shared memory, and whether
    copies are 16 bytes wide."""
    stride = 4 * (((d + 3) // 4 + 1) | 1)
    room = ((_native.SHARED_MEMORY_BYTES - _FWD_STATIC) // (4 * (stride + 1))
            - CHUNK_ROWS)
    tile_rows = min(-(-n // COLUMN_BLOCK), room // COLUMN_BLOCK) * COLUMN_BLOCK
    if tile_rows < COLUMN_BLOCK:
        raise ValueError(f"D = {d}: one column block of K2f does not fit "
                         f"in shared memory")
    return dict(rows_per_block=-(-n // CLUSTER), chunk_rows=CHUNK_ROWS,
                stride=stride, tile_rows=tile_rows,
                tiles=-(-n // tile_rows),
                smem_bytes=(CHUNK_ROWS + tile_rows) * (stride + 1) * 4,
                vec=d % 4 == 0 and aligned)


def _check(z: torch.Tensor) -> None:
    if z.dtype != torch.float32 or z.dim() != 3 or not z.is_contiguous():
        raise ValueError(f"z must be a contiguous (P, n, D) float32 tensor, "
                         f"got {tuple(z.shape)} {z.dtype}")
    p, n, d = z.shape
    if not 1 <= p <= 65535 or n < 2 or n % 2 or not 1 <= d <= MAX_DIM:
        raise ValueError(f"z shape {tuple(z.shape)}: need 1 <= P <= 65535, "
                         f"even n >= 2 and 1 <= D <= {MAX_DIM}")


def ntxent_forward_cuda(z: torch.Tensor, temperature: float):
    """K2f: z (P, n, D) f32 on CUDA -> (loss (P,), lse (P, n), inv (P, n)),
    in one kernel launch."""
    if not z.is_cuda:
        raise ValueError("ntxent_forward_cuda takes a CUDA tensor")
    _check(z)
    p, n, d = z.shape
    plan = ntxent_forward_plan(n, d, aligned=z.data_ptr() % 16 == 0)
    loss = torch.empty(p, device=z.device, dtype=torch.float32)
    lse = torch.empty(p, n, device=z.device, dtype=torch.float32)
    inv = torch.empty_like(lse)
    lib = _native.library()
    ntxent_forward_cuda.launches += 1
    _native.check(lib.sm3x_ntxent_fwd(
        z.data_ptr(), loss.data_ptr(), lse.data_ptr(), inv.data_ptr(),
        p, n, d, plan["tile_rows"], int(plan["vec"]), float(temperature),
        _native.stream_handle(z.device)), "sm3x_ntxent_fwd")
    return loss, lse, inv


ntxent_forward_cuda.launches = 0


def ntxent_backward_plain(z, lse, inv, g, temperature: float):
    """The analytic gradient K2b computes, in torch (not autograd):
    p_ij = exp(S_ij - lse_i) off the diagonal,
    dzh_i = g / (n T) * (sum_j (p_ij + p_ji) zh_j - 2 zh_pos(i)),
    dz_i = (dzh_i - zh_i (dzh_i . zh_i)) * inv_i."""
    _, n, _ = z.shape
    inv = inv[..., None]
    zh = z * inv
    s = torch.bmm(zh, zh.transpose(1, 2)) / temperature
    prob = torch.exp(s - lse[..., None])
    prob = prob.masked_fill(torch.eye(n, dtype=torch.bool, device=z.device), 0)
    pos_idx = (torch.arange(n, device=z.device) + n // 2) % n
    dzh = torch.bmm(prob + prob.transpose(1, 2), zh) - 2 * zh[:, pos_idx]
    dzh = dzh * (g / (n * temperature))[:, None, None]
    proj = (dzh * zh).sum(-1, keepdim=True)
    return (dzh - zh * proj) * inv


def ntxent_backward_cuda(z, lse, inv, g, temperature: float):
    """K2b: the analytic gradient of the per-problem losses, on CUDA."""
    for t in (z, lse, inv, g):
        if not t.is_cuda:
            raise ValueError("ntxent_backward_cuda takes CUDA tensors")
    _check(z)
    p, n, _ = z.shape
    if (lse.shape != (p, n) or inv.shape != (p, n) or g.shape != (p,)
            or not all(t.dtype == torch.float32 and t.is_contiguous()
                       for t in (lse, inv, g))):
        raise ValueError("lse/inv must be (P, n) and g (P,), contiguous f32")
    dz = torch.empty_like(z)
    lib = _native.library()
    ntxent_backward_cuda.launches += 1
    _native.check(lib.sm3x_ntxent_bwd(
        z.data_ptr(), lse.data_ptr(), inv.data_ptr(), g.data_ptr(),
        dz.data_ptr(), p, n, z.shape[2], float(temperature),
        _native.stream_handle(z.device)), "sm3x_ntxent_bwd")
    return dz


ntxent_backward_cuda.launches = 0


class NTXentFunction(torch.autograd.Function):
    """Per-problem NT-Xent losses with the analytic backward."""

    @staticmethod
    def forward(ctx, z, temperature):
        if z.is_cuda:
            z = z.float().contiguous()
            loss, lse, inv = ntxent_forward_cuda(z, temperature)
        else:
            loss, lse, inv = ntxent_forward_plain(z, temperature)
            z = z.to(loss.dtype)
        ctx.save_for_backward(z, lse, inv)
        ctx.temperature = temperature
        return loss

    @staticmethod
    def backward(ctx, g):
        z, lse, inv = ctx.saved_tensors
        g = g.to(z.dtype).contiguous()
        if z.is_cuda:
            dz = ntxent_backward_cuda(z, lse, inv, g, ctx.temperature)
        else:
            dz = ntxent_backward_plain(z, lse, inv, g, ctx.temperature)
        return dz, None


def ntxent_problems_loss(z: torch.Tensor, temperature: float) -> torch.Tensor:
    """z (P, 2b, D) -> per-problem NT-Xent losses (P,), differentiable."""
    return NTXentFunction.apply(z, float(temperature))
