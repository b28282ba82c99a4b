#!/usr/bin/env python
"""K2b (NT-Xent backward) at other warps a block and blocks a problem than
its shape plan picks, on one NVIDIA GPU: the sweep behind
`ntxent_backward_plan`'s constants (sm3x_torch/ops/ntxent_cuda.py).

    python tools/k2b_variants_torch.py           # z (8, 96, 128)

The library's entry point takes the warps a block and the blocks a problem
as arguments, so no variant needs a build of its own. A block copies the
problem's tile from L2: fewer blocks copy less, more blocks run more rows
at once. Each line is one (warps, row groups a block): the largest error
over the bound (rtol 1e-4, atol 1e-6) against the plain version, the
kernel alone (torch.profiler, twice) and the device time a launch (CUDA
events around 50 launches in a row, which reads the host for so short a
kernel). Then the plan's own choice through the wrapper, and K2f and the
launch floor beside it.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPE, T = (8, 96, 128), 0.1
SWEEP = ((8, (1, 2, 4)), (4, (1, 2, 4, 8)), (2, (1, 2, 4)), (1, (1, 2)))


def main() -> int:
    from sm3x_torch.ops import _native, copy_cuda
    from sm3x_torch.ops import ntxent_cuda as N
    from sm3x_torch.utils.timing import (device_ms, kernel_ms,
                                         nvidia_smi_name_and_limit)

    print(nvidia_smi_name_and_limit())
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _native.library()
    gen = torch.Generator(device="cuda").manual_seed(3)
    z = torch.randn(SHAPE, device="cuda", generator=gen)
    g = torch.rand(SHAPE[0], device="cuda", generator=gen)
    p, n, d = SHAPE
    _, lse, inv = N.ntxent_forward_cuda(z, T)
    want = N.ntxent_backward_plain(z, lse, inv, g, T)
    dz = torch.empty_like(z)
    stream = _native.stream_handle(z.device)
    plan = N.ntxent_backward_plan(n, d)
    print(f"plan for {SHAPE}: {plan}")

    def run(warps, blocks):
        _native.check(lib.sm3x_ntxent_bwd(
            z.data_ptr(), lse.data_ptr(), inv.data_ptr(), g.data_ptr(),
            dz.data_ptr(), p, n, d, plan["tile_rows"],
            plan["column_block"] // 32, warps, blocks, 1, T, stream),
            "sm3x_ntxent_bwd")

    for warps, groups in SWEEP:
        for chunks in groups:
            blocks = -(-n // (3 * warps * chunks))
            dz.fill_(float("nan"))
            run(warps, blocks)
            torch.cuda.synchronize()
            err = float(((dz - want).abs()
                         / (1e-6 + 1e-4 * want.abs())).max())
            fn = lambda: run(warps, blocks)
            alone = [kernel_ms(fn, 50) for _ in range(2)]
            print(f"warps {warps} row groups a block {chunks} blocks "
                  f"{blocks:2d}: err/bound {err:.3f}; alone "
                  f"{alone[0]:.4f} {alone[1]:.4f} ms, device "
                  f"{device_ms(fn):.4f} ms", flush=True)
    one = torch.zeros(1, device="cuda")
    for name, fn in (
            ("K2b through its wrapper",
             lambda: N.ntxent_backward_cuda(z, lse, inv, g, T)),
            ("K2f through its wrapper", lambda: N.ntxent_forward_cuda(z, T)),
            ("launch floor (K4 over one element)",
             lambda: copy_cuda.copy_cuda(one))):
        print(f"{name}: alone {kernel_ms(fn, 50):.4f} ms, device "
              f"{device_ms(fn):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
