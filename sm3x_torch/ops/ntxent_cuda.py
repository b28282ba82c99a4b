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

# K2f's shape (csrc/ntxent.cu): a cluster of CLUSTER blocks a problem, a
# block CHUNK_ROWS of its rows at a time against tiles of the problem's rows
# that are a multiple of a column block long: 96 (32 lanes x 3 columns), or
# 32 (x 1 column) where D is too wide for 96 rows in shared memory
CLUSTER, CHUNK_ROWS, COLUMN_BLOCKS = 8, 12, (96, 32)
_FWD_STATIC = 128  # bytes of static shared memory the forward declares
# K2b's shape: no cluster; a block takes 3 rows a warp at a time, with as
# many warps as leave room for a tile; a problem of one tile gives a block
# BWD_CHUNKS of those row groups (each block copies the tile from L2: fewer
# blocks copy less, more blocks run more rows at once; picked by timing,
# tools/k2b_variants_torch.py), a problem that streams tiles one
ROWS_PER_WARP, BWD_WARPS, BWD_CHUNKS = 3, (4, 2, 1), 1


def tile_stride(d: int) -> int:
    """The padded row stride of a tile in floats: the least odd number of
    16-byte steps with a step of padding, so that reads down a column hit
    distinct banks."""
    return 4 * (((d + 3) // 4 + 1) | 1)


def _column_block(room: int):
    return next((cb for cb in COLUMN_BLOCKS if room >= cb), None)


def ntxent_forward_plan(n: int, d: int, aligned: bool = True) -> dict:
    """How K2f runs an (n, D) problem, from the shape alone: rows a block,
    the padded row stride, the column block (96, or 32 for a wide D), the
    rows of a tile (the whole problem rounded up to the column block where
    that fits in shared memory beside the block's own CHUNK_ROWS rows and
    every row's inverse norm, else the largest multiple of it that does),
    the number of tiles, the dynamic shared memory, and whether copies are
    16 bytes wide."""
    stride = tile_stride(d)
    room = ((_native.SHARED_MEMORY_BYTES - _FWD_STATIC) // (4 * (stride + 1))
            - CHUNK_ROWS)
    block = _column_block(room)
    if block is None:
        raise ValueError(
            f"D = {d}: K2f's {CHUNK_ROWS} rows and one block of "
            f"{COLUMN_BLOCKS[-1]} columns do not fit in the "
            f"{_native.SHARED_MEMORY_BYTES} bytes of shared memory a block has")
    tile_rows = min(-(-n // block), room // block) * block
    return dict(rows_per_block=-(-n // CLUSTER), chunk_rows=CHUNK_ROWS,
                stride=stride, column_block=block, tile_rows=tile_rows,
                tiles=-(-n // tile_rows),
                smem_bytes=(CHUNK_ROWS + tile_rows) * (stride + 1) * 4,
                vec=d % 4 == 0 and aligned)


def ntxent_backward_plan(n: int, d: int, aligned: bool = True) -> dict:
    """How K2b runs an (n, D) problem: the warps a block (the most of
    BWD_WARPS that leave room for one column block of the tile), the rows
    a block takes at a time (3 a warp), the stride, column block, tile and
    tiles as in the forward, the blocks a problem and the rows each takes,
    and the dynamic shared memory: the block's rows and their partial sums
    (chunk x stride each), the tile, the coefficients (chunk x tile rows),
    and inv and lse of both. It accepts every shape the forward's plan
    does."""
    stride = tile_stride(d)
    for warps in BWD_WARPS:
        chunk = ROWS_PER_WARP * warps
        room = ((_native.SHARED_MEMORY_BYTES - 4 * chunk * (2 * stride + 2))
                // (4 * (stride + 2 + chunk)))
        block = _column_block(room)
        if block is not None:
            break
    else:
        raise ValueError(
            f"D = {d}: K2b's {chunk} rows, their sums and one block of "
            f"{COLUMN_BLOCKS[-1]} columns do not fit in the "
            f"{_native.SHARED_MEMORY_BYTES} bytes of shared memory a block has")
    tile_rows = min(-(-n // block), room // block) * block
    tiles = -(-n // tile_rows)
    blocks = -(-n // (chunk * (BWD_CHUNKS if tiles == 1 else 1)))
    return dict(warps=warps, chunk_rows=chunk, stride=stride,
                column_block=block, tile_rows=tile_rows, tiles=tiles,
                blocks=blocks, rows_per_block=-(-n // blocks),
                smem_bytes=4 * (chunk * (2 * stride + tile_rows + 2)
                                + tile_rows * (stride + 2)),
                vec=d % 4 == 0 and aligned)


def _check(z: torch.Tensor) -> None:
    """The type and shape the kernels take; how wide D may be is for the
    shape plans, which raise where a block's rows outgrow shared memory."""
    if z.dtype != torch.float32 or z.dim() != 3 or not z.is_contiguous():
        raise ValueError(f"z must be a contiguous (P, n, D) float32 tensor, "
                         f"got {tuple(z.shape)} {z.dtype}")
    p, n, d = z.shape
    if not 1 <= p <= 65535 or n < 2 or n % 2 or d < 1:
        raise ValueError(f"z shape {tuple(z.shape)}: need 1 <= P <= 65535, "
                         f"even n >= 2 and D >= 1")


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
    _native.check(lib.sm3x_ntxent_fwd(
        z.data_ptr(), loss.data_ptr(), lse.data_ptr(), inv.data_ptr(),
        p, n, d, plan["tile_rows"], plan["column_block"] // 32,
        int(plan["vec"]), float(temperature),
        _native.stream_handle(z.device)), "sm3x_ntxent_fwd")
    return loss, lse, inv


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
    """K2b: the analytic gradient of the per-problem losses, on CUDA, in
    one kernel launch."""
    for t in (z, lse, inv, g):
        if not t.is_cuda:
            raise ValueError("ntxent_backward_cuda takes CUDA tensors")
    _check(z)
    p, n, d = z.shape
    if (lse.shape != (p, n) or inv.shape != (p, n) or g.shape != (p,)
            or not all(t.dtype == torch.float32 and t.is_contiguous()
                       for t in (lse, inv, g))):
        raise ValueError("lse/inv must be (P, n) and g (P,), contiguous f32")
    dz = torch.empty_like(z)
    plan = ntxent_backward_plan(
        n, d, aligned=z.data_ptr() % 16 == 0 and dz.data_ptr() % 16 == 0)
    lib = _native.library()
    _native.check(lib.sm3x_ntxent_bwd(
        z.data_ptr(), lse.data_ptr(), inv.data_ptr(), g.data_ptr(),
        dz.data_ptr(), p, n, d, plan["tile_rows"],
        plan["column_block"] // 32, plan["warps"], plan["blocks"],
        int(plan["vec"]), float(temperature),
        _native.stream_handle(z.device)), "sm3x_ntxent_bwd")
    return dz


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
