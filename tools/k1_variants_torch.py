#!/usr/bin/env python
"""K1's band kernel at other cluster sizes and block sizes than its shape
plan picks, on one NVIDIA GPU: the sweep behind `photometric_plan`'s
constants (sm3x_torch/ops/augment_cuda.py).

    python tools/k1_variants_torch.py            # (96, 224, 224, 3)

The library's entry point takes the blocks an image, the rows a block and
the threads a block as arguments, so no variant needs a build of its own.
Each line is one (blocks, threads): the largest error over the bound
(rtol 1e-4, atol 1e-5) against the plain version, then the device time a
launch (CUDA events around 50 launches in a row) for four parameter
matrices: the smoke run's (every flag combination and op order, half the
images jittered), every image jittered, no step applied (a copy through
shared memory with the normalisation), and one drawn as the trainer draws
it (`build_params`, SSL preset). The last line is `Tensor.clone` of the
same images: one read and one write of them by the library.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SWEEP = ((4, (512,)), (8, (256, 512)), (12, (256,)), (14, (192, 256, 320)),
         (16, (128, 256, 320)))


def main() -> int:
    import chip_smoke as c
    from sm3x_torch.ops import _native
    from sm3x_torch.ops import augment as A
    from sm3x_torch.ops import augment_cuda as K

    print(c.phase_device())
    lib = _native.library()
    images, params = c.k1_inputs()
    b, h, w, _ = images.shape
    want = K.photometric_plain(images, params, c.MEAN, c.STD)
    out = torch.empty_like(images)
    stream = _native.stream_handle(images.device)
    jittered, copy = params.clone(), params.clone()
    jittered[:, K.P_DO_JIT] = 1.0
    for col in (K.P_DO_JIT, K.P_DO_GRAY, K.P_DO_FLIP, K.P_DO_BLUR):
        copy[:, col] = 0.0
    gen = torch.Generator(device="cuda").manual_seed(5)
    drawn = K.build_params(gen, b, A.SSL_AUG, "cuda")

    def run(par, blocks, threads):
        _native.check(lib.sm3x_photometric_band(
            images.data_ptr(), par.data_ptr(), out.data_ptr(), b, h, w,
            blocks, -(-h // blocks), 4, threads, *c.MEAN, *c.STD, stream),
            "sm3x_photometric_band")

    plan = K.photometric_plan(h, w)
    print(f"plan for {h} x {w}: {plan}")
    for blocks, sizes in SWEEP:
        for threads in sizes:
            run(params, blocks, threads)
            torch.cuda.synchronize()
            err = float(((out - want).abs()
                         / (1e-5 + 1e-4 * want.abs())).max())
            t = [c.device_ms(lambda: run(par, blocks, threads))
                 for par in (params, jittered, copy, drawn, params)]
            print(f"blocks {blocks:2d} rows {-(-h // blocks):3d} threads "
                  f"{threads}: err/bound {err:.3f}; smoke's {t[0]:.4f} "
                  f"{t[4]:.4f}, all jittered {t[1]:.4f}, no step {t[2]:.4f}, "
                  f"trainer's {t[3]:.4f} ms", flush=True)
    print(f"clone of the images: {c.device_ms(images.clone):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
