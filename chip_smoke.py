#!/usr/bin/env python
"""Smoke run of the PyTorch port (sm3x_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card

Phases, each printing its lines:
  device   the card's name and power limit (fails without CUDA)
  build    nvcc builds sm3x_torch/csrc/*.cu (seconds, ptxas register use)
  kernels  K1 (photometric), K2f / K2b (NT-Xent), K3f / K3b-dq / K3b-dkv
           (flash attention) and K4 (copy) against their plain PyTorch
           versions on the card, in float32 with TF32 off, at the stage-1
           shapes (K1 also at a shape that takes its general-shape kernel,
           with the kernel each shape took; K2 also at --proj-dim 640, at
           rows that stream several tiles and at an odd D off the 16-byte
           copies; K1, K2f and K2b twice for identical bits; K3 also in bf16 at ViT-B's (64, 197, 12, 64), where it
           runs on the tensor cores and is held against the plain versions
           in float32 and in the TPU kernels' bf16 arithmetic; K4 over 256
           MiB, exact). Times of each: `ms`, the median of 20 single
           launches between two events (the wrapper's host work included);
           `device_ms`, events around 50 launches in a row over the count;
           `plain_ms`, the plain version as `ms`; for K3 `plain_bf16_ms`,
           the plain attention in bf16 on the tensor cores (`attention_xla`
           and its autograd backward); `library_ms`, timed as `device_ms`,
           of the one PyTorch call that computes the same function
           (`F.scaled_dot_product_attention` and its autograd backward for
           K3, `Tensor.clone` for K4; the port calls neither), K4 and clone
           in turns; and `bound_ms`, the least time the card could take,
           from the shapes and the H100's published peaks; `kernel_ms`,
           the kernels' own time a call under torch.profiler, from which
           the share of the bound is taken; and `launch_floor_ms`: K4 over
           one element, timed as `device_ms` (the bounds of K2f and K2b lie
           below what any launch costs, so their rows are read against it)
  step     one fp32 step of a small model on the card against the same step
           on the CPU (plain versions), from the same weights and views
  main     the stage-1 trainer at the run.sh recipe (resnet50, v32, proj 128,
           T 0.1, global batch 96, --world-size 2, lr 1e-6, AdamW eps 1e-5,
           bf16 autocast, 224x224) over in-memory synthetic canvases: per-step
           losses, kernel launch counts (K1's by kernel: every launch at
           224x224 must take the band kernel), step time, images/s, peak
           memory
  stage2   the stage-2 trainer at the run.sh recipe (two frozen resnet50
           from the ckp_0.pth that `main` wrote, 224x224, batch 256, v4
           projectors of 512, 1 head, ff 128, dropout 0.1, T 1, lr 1e-4,
           float32) over 1024 synthetic cases: the init pass and 2 epochs
           through MLCTrainer.fit; finite losses, K1 launched twice a step
           (band kernel only) and no other kernel, assignments within each
           label's classes, prototype weights equal to unit-norm centroids
           after a clustering, the extractor's weights bit-identical to
           the checkpoint and its running statistics moved by the init
           pass alone, ckp_1.pth; the times of the init pass, of an epoch's
           k-means and of a step, peak memory
  vit      the same trainer with a ViT-B/16 encoder pair (vit_b16, v32, proj
           128, T 0.1, batch 64, --world-size 2, bf16 autocast, 224x224,
           --use-checkpoint flash): attention through K3 forward and
           backward, 48 launches of each a step, every one the tensor-core
           kernel; losses, launch counts, step time, images/s, peak memory
  copy     tools/bench_copy_torch.py (K4 against `x + 1`, GB/s)

With `--profile DIR`, the main, stage2 and vit phases also trace three more
steps with torch.profiler and write the device-time tables to
DIR/profile_step.txt, DIR/profile_stage2.txt and DIR/profile_vit.txt.

The last lines are a JSON object of the kernels, the card's name and power
limit as nvidia-smi prints them, and {"ok": true, "device": {...}}. Any
failed phase raises and the script exits non-zero without that last line.
The script imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# the clocks (also bench_torch.py's); importing them fails outside a checkout
from sm3x_torch.utils.timing import (device_ms, kernel_ms, median_ms,  # noqa: E402
                                     nvidia_smi_name_and_limit,
                                     profile_device)

MAIN_STEPS, MAIN_BATCH = 4, 96          # run.sh: global batch 96
VIT_STEPS, VIT_BATCH = 4, 64            # bench.py 64 30 vit_b16
K1_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_augment_pallas.py:69
K2F_TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_ntxent_pallas.py:19
K2B_TOL = dict(rtol=1e-4, atol=1e-6)     # tests/test_ntxent_pallas.py:31
K3F_TOL = dict(rtol=1e-5, atol=1e-5)     # tests/test_vit_trimodal.py:77
K3B_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_vit_trimodal.py:46
K3_BF16_FWD, K3_BF16_REL = 0.02, 0.03    # tests/flash_tpu_check.py:53,65
# K3b in bf16 against the plain backward in the same bf16 arithmetic, both
# rounded to bf16: relative Frobenius error (measured <= 7.8e-5 on an H100;
# the float32 plain backward, rounded, is 2.6e-3 from it)
K3_BF16_ARITH = 5e-4
# K3f in bf16 the same way, against the plain forward in bf16 arithmetic with
# K3f's key tile (measured 8.3e-5 on an H100; the float32 plain forward,
# rounded, is 2.1e-3 from it); its logsumexp within rtol / atol 1e-4
K3F_LSE_TOL = dict(rtol=1e-4, atol=1e-4)
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
VIT_SHAPE = (64, 197, 12, 64)            # ViT-B/16 at 224, batch 64
LOGS = os.path.join(ROOT, "build", "chip_smoke_logs")  # a folder a phase
MEAN = (0.7833, 0.6712, 0.6026)          # run.sh Derm7pt statistics
STD = (0.2139, 0.2472, 0.2571)


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name, got, want, rtol, atol) -> float:
    """Max abs error; raises if any |got - want| > atol + rtol |want|."""
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    worst = float((err / bound).max())
    max_abs = float(err.max())
    log(f"  {name}: max abs err {max_abs:.3e}, worst err/bound {worst:.3f} "
        f"(rtol {rtol:g}, atol {atol:g})")
    if not bool(torch.isfinite(got).all()) or worst > 1.0:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


def ms_or_not(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes that
    must move (each input read once, each output written once) over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[kind]
    t = max(t_bytes, t_ops)
    return dict(bound_ms=t * 1e3, bound_us=t * 1e6,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on an NVIDIA GPU only")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_name_and_limit()
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    """Build the kernels and print ptxas's registers and spills by kernel;
    the tensor-core K3 kernels (namespace sm3x) must not spill."""
    import re

    from sm3x_torch.ops import _native

    _native.library()
    log(f"[build] nvcc {_native.nvcc_path()}: {_native.build_seconds:.1f} s "
        f"(0.0 = library already built)")
    name, spills = "?", ""
    for ln in _native.build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
        elif "spill" in ln:
            spills = ln.strip()
        elif "registers" in ln:
            used = ln.split(":", 1)[1].strip()
            short = re.search(r"[a-z_]*kernel(ILi(\d+)E)?", name)
            label = name[:60]
            if short:
                label = short.group(0).split("ILi")[0] + (
                    f"<{short.group(2)}>" if short.group(2) else "")
            log(f"  ptxas {label}"
                f"{' (sm3x)' if '_ZN4sm3x' in name else ''}: {used}; {spills}")
            if "_ZN4sm3x" in name and "0 bytes spill stores" not in spills:
                raise AssertionError(f"{name} spills registers: {spills}")


def k1_inputs(batch=96, size=224):
    """Images in [0, 1] and a params matrix that mixes every flag
    combination and every jitter op order."""
    from itertools import permutations

    from sm3x_torch.ops import augment as A
    from sm3x_torch.ops import augment_cuda as K

    rng = np.random.default_rng(1)
    images = torch.from_numpy(
        rng.random((batch, size, size, 3), dtype=np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = K.build_params(gen, batch, A.SSL_AUG, "cuda")
    orders = list(permutations(range(4)))
    for i in range(batch):
        params[i, K.P_ORD0:K.P_ORD0 + 4] = torch.tensor(
            orders[i % len(orders)], dtype=torch.float32)
        for bit, col in enumerate((K.P_DO_JIT, K.P_DO_GRAY, K.P_DO_FLIP,
                                   K.P_DO_BLUR)):
            params[i, col] = float((i >> bit) & 1)
    return images, params.contiguous()


def phase_kernels():
    """Every kernel against its plain version, with its times: (the rows of
    the kernels line by name, the launch floor's two times)."""
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.ops import copy_cuda as C
    from sm3x_torch.ops import ntxent_cuda as N

    # what any launch through a wrapper costs: K4 over one element
    one = torch.zeros(1, device="cuda")
    floor = dict(launch_floor_ms=device_ms(lambda: C.copy_cuda(one)),
                 launch_floor_kernel_ms=kernel_ms(lambda: C.copy_cuda(one)))
    log(f"[kernels] launch floor: K4 over one element "
        f"{floor['launch_floor_ms']:.4f} ms device time (50 launches in a "
        f"row, the wrapper's host work between them), the kernel alone "
        f"{ms_or_not(floor['launch_floor_kernel_ms'])}")

    results = {}
    # the general-shape kernel, then the stage-1 shape
    for batch, size, kernel in ((16, 640, "scratch"), (96, 224, "band")):
        images, params = k1_inputs(batch, size)
        plan = K.photometric_plan(size, size)
        before = dict(K.photometric_cuda.variants)
        got = K.photometric_cuda(images, params, MEAN, STD)
        again = K.photometric_cuda(images, params, MEAN, STD)
        want = K.photometric_plain(images, params, MEAN, STD)
        torch.cuda.synchronize()
        log(f"[kernels] K1 photometric {tuple(images.shape)}: {plan['kernel']}"
            f" kernel, {plan['blocks']} blocks an image of "
            f"{plan['band_rows']} rows, {plan['px']} pixels a thread, "
            f"{plan['smem_bytes']} bytes of shared memory a block")
        took = {k: v - before[k]
                for k, v in K.photometric_cuda.variants.items()}
        if plan["kernel"] != kernel or took != {
                **dict.fromkeys(took, 0), kernel: 2}:
            raise AssertionError(f"K1 at {size} x {size} took {took}, "
                                 f"expected the {kernel} kernel")
        err = check_close("K1 out", got, want, **K1_TOL)
        if not torch.equal(got, again):
            raise AssertionError("K1 does not repeat bit for bit")
        del want, again
    # about 130 float32 operations a pixel when every step applies (four
    # jitter rounds with the HSV rotation, gray, 3 x 3 blur, normalise)
    k1 = lambda: K.photometric_cuda(images, params, MEAN, STD)
    results["photometric"] = dict(
        max_abs_err=err, ms=median_ms(k1), device_ms=device_ms(k1),
        kernel_ms=kernel_ms(k1),
        plain_ms=median_ms(
            lambda: K.photometric_plain(images, params, MEAN, STD)),
        library_ms=None,
        **bound(nbytes(images, params, got), 130 * images[..., 0].numel(),
                "f32"))

    errs = {"fwd": 0.0, "bwd": 0.0}
    rng = np.random.default_rng(3)
    # the stage-1 shape (4 terms x 2 groups); more rows; --proj-dim 640 (two
    # tiles of 32-column blocks); rows that stream five tiles; an odd D off
    # the 16-byte copies
    for shape in ((8, 96, 128), (4, 256, 128), (8, 96, 640), (2, 300, 520),
                  (3, 14, 131)):
        z = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
        g = torch.from_numpy(rng.random(shape[0], dtype=np.float32)).cuda()
        loss, lse, inv = N.ntxent_forward_cuda(z, 0.1)
        if not all(torch.equal(a, b) for a, b in zip(
                (loss, lse, inv), N.ntxent_forward_cuda(z, 0.1))):
            raise AssertionError("K2f does not repeat bit for bit")
        loss_p, lse_p, inv_p = N.ntxent_forward_plain(z, 0.1)
        dz = N.ntxent_backward_cuda(z, lse, inv, g, 0.1)
        if not torch.equal(dz, N.ntxent_backward_cuda(z, lse, inv, g, 0.1)):
            raise AssertionError("K2b does not repeat bit for bit")
        dz_p = N.ntxent_backward_plain(z, lse_p, inv_p, g, 0.1)
        # the plain backward through autograd of the plain forward
        zr = z.clone().requires_grad_(True)
        (N.ntxent_forward_plain(zr, 0.1)[0] * g).sum().backward()
        torch.cuda.synchronize()
        fp, bp = (plan(*shape[1:]) for plan in (N.ntxent_forward_plan,
                                                N.ntxent_backward_plan))
        log(f"[kernels] K2 ntxent z {shape}: K2f {fp['tiles']} tile(s) of "
            f"{fp['tile_rows']} rows, {fp['smem_bytes']} bytes; K2b "
            f"{bp['blocks']} blocks a problem of {bp['warps']} warps, "
            f"{bp['tiles']} tile(s) of {bp['tile_rows']} rows, "
            f"{bp['smem_bytes']} bytes")
        errs["fwd"] = max(errs["fwd"], check_close("K2f loss", loss, loss_p,
                                                   **K2F_TOL))
        errs["bwd"] = max(errs["bwd"], check_close("K2b dz", dz, dz_p,
                                                   **K2B_TOL))
        check_close("K2f lse", lse, lse_p, **K2F_TOL)
        check_close("plain dz vs autograd", dz_p, zr.grad, **K2B_TOL)
        k2f = lambda: N.ntxent_forward_cuda(z, 0.1)
        k2b = lambda: N.ntxent_backward_cuda(z, lse, inv, g, 0.1)
        if shape == (8, 96, 128):  # the stage-1 shape: its times are the rows'
            # S = z z^T is 2 P n^2 D operations; the backward recomputes it
            # and multiplies the probabilities into z once more
            s_flops = 2 * shape[0] * shape[1] ** 2 * shape[2]
            results["ntxent_fwd"] = dict(
                ms=median_ms(k2f), device_ms=device_ms(k2f),
                kernel_ms=kernel_ms(k2f),
                plain_ms=median_ms(lambda: N.ntxent_forward_plain(z, 0.1)),
                library_ms=None,
                **bound(nbytes(z, loss, lse, inv), s_flops, "f32"))
            results["ntxent_bwd"] = dict(
                ms=median_ms(k2b), device_ms=device_ms(k2b),
                kernel_ms=kernel_ms(k2b),
                plain_ms=median_ms(lambda: N.ntxent_backward_plain(
                    z, lse_p, inv_p, g, 0.1)),
                library_ms=None,
                **bound(nbytes(z, lse, inv, g, dz), 2 * s_flops, "f32"))
        else:
            log(f"  the kernels alone (profiler): K2f "
                f"{ms_or_not(kernel_ms(k2f))}, K2b {ms_or_not(kernel_ms(k2b))}")
    results["ntxent_fwd"]["max_abs_err"] = errs["fwd"]
    results["ntxent_bwd"]["max_abs_err"] = errs["bwd"]
    results.update(k3_kernels())
    results["copy"] = k4_kernel()
    for name, r in results.items():
        bf16 = (f", plain bf16 {r['plain_bf16_ms']:.4f} ms"
                if "plain_bf16_ms" in r else "")
        lib = (f", library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        # the share of the bound from the kernel alone; `device_ms` reads
        # the host for a short kernel and stands in only where the profiler
        # gave no device time
        alone = r["kernel_ms"] if r["kernel_ms"] is not None else r["device_ms"]
        r["share_of_bound"] = r["bound_ms"] / alone
        log(f"  {name}: kernel {r['ms']:.4f} ms a single launch (median of "
            f"20), {r['device_ms']:.4f} ms device time (50 launches in a "
            f"row, {r['device_ms'] / floor['launch_floor_ms']:.1f} x the "
            f"launch floor), the kernel alone {ms_or_not(r['kernel_ms'])} "
            f"(profiler), bound {r['bound_us']:.1f} us ({r['bound_by']}, "
            f"{100 * r['share_of_bound']:.1f}% of it reached by the kernel "
            f"alone), plain {r['plain_ms']:.4f} ms{bf16}{lib}")
    return results, floor


def k3_kernels() -> dict:
    """K3f, K3b-dq and K3b-dkv against the plain forward and analytic
    backward: float32 at a small ragged shape and at ViT-B's (the FMA
    kernels), and bf16 at ViT-B's (the tensor-core kernels) against the
    plain float32 versions on the same bf16 inputs and against the plain
    versions in bf16 arithmetic (the forward with K3f's key tile, the
    backward on the kernels' own out and lse). The times are those of the
    bf16 launches, the slice's; the plain time of both backward kernels is
    the whole plain backward, which computes dq, dk and dv together:
    `plain_ms` in float32 (the analytic backward), and `plain_bf16_ms` as
    `--use-checkpoint off` runs attention, in bf16 on the tensor cores
    (`attention_xla`, and its autograd backward replayed on one graph).
    `library_ms` is `F.scaled_dot_product_attention` on (B, H, S, D) views
    of the same tensors, and its autograd backward (one time for both
    backward kernels). max_abs_err is the largest of the float32 checks
    and, for K3f, of the bf16 forward."""
    import torch.nn.functional as F

    from sm3x_torch.ops import attention as A
    from sm3x_torch.ops import attention_cuda as K

    rng = np.random.default_rng(5)
    k3 = (K.flash_forward_cuda, K.flash_backward_dq_cuda,
          K.flash_backward_dkv_cuda)

    def run(shape, dtype):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).cuda().to(dtype) for _ in range(4))
        scale = 1.0 / math.sqrt(shape[3])
        kind = "mma" if dtype == torch.bfloat16 else "fma"
        before = [fn.variants[kind] for fn in k3]
        out, lse = K.flash_forward_cuda(q, k, v, scale)
        dq, delta = K.flash_backward_dq_cuda(q, k, v, out, do, lse, scale)
        dk, dv = K.flash_backward_dkv_cuda(q, k, v, do, lse, delta, scale)
        if [fn.variants[kind] for fn in k3] != [n + 1 for n in before]:
            raise AssertionError(f"K3 in {dtype} did not run its {kind} "
                                 f"kernels")
        f = [t.float() for t in (q, k, v, do)]
        out_p, lse_p = A.attention_plain(*f[:3], scale)
        grads_p = A.attention_backward_plain(*f[:3], out_p, f[3], lse_p,
                                             scale)
        torch.cuda.synchronize()
        log(f"[kernels] K3 flash attention {shape} "
            f"{str(dtype).replace('torch.', '')} ({kind} kernels)")
        return ((q, k, v, do, scale), (out, lse, delta),
                zip(("dq", "dk", "dv"), (dq, dk, dv), grads_p), (out_p, lse_p))

    def rel_bf16(got, want):  # against `want` rounded to bf16
        want = want.bfloat16().float()
        return float((got.float() - want).norm() / want.norm())

    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for shape in ((3, 100, 5, 64), VIT_SHAPE):
        _, (out, lse, _), grads, (out_p, lse_p) = run(shape, torch.float32)
        errs["flash_fwd"] = max(errs["flash_fwd"], check_close(
            "K3f out", out, out_p, **K3F_TOL))
        check_close("K3f lse", lse, lse_p, **K3F_TOL)
        for name, got, want in grads:
            key = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
            errs[key] = max(errs[key], check_close(f"K3b {name}", got, want,
                                                   **K3B_TOL))

    (q, k, v, do, scale), (out, lse, delta), grads, (out_p, lse_p) = run(
        VIT_SHAPE, torch.bfloat16)
    f = [t.float() for t in (q, k, v, do)]
    e = float((out.float() - out_p).abs().max())
    out_bf16, lse_bf16 = A.attention_plain(
        *f[:3], scale, operand_dtype=torch.bfloat16, block_k=K.KEY_TILE)
    rel = rel_bf16(out, out_bf16)
    log(f"  K3f out (bf16, tensor cores): max abs err {e:.3e} against "
        f"float32 (bound {K3_BF16_FWD}), relative Frobenius err {rel:.3e} "
        f"against the bf16 arithmetic (bound {K3_BF16_ARITH}; the float32 "
        f"plain forward, rounded, is {rel_bf16(out_bf16, out_p):.3e} from it)")
    if not (e < K3_BF16_FWD and rel < K3_BF16_ARITH):
        raise AssertionError("K3f in bf16 disagrees with its plain version")
    check_close("K3f lse (bf16)", lse, lse_bf16, **K3F_LSE_TOL)
    check_close("K3f lse (bf16) against float32", lse, lse_p, **K3F_LSE_TOL)
    errs["flash_fwd"] = max(errs["flash_fwd"], e)
    grads_bf16 = A.attention_backward_plain(
        *f[:3], out.float(), f[3], lse, scale, operand_dtype=torch.bfloat16)
    for (name, got, want), want_bf16 in zip(grads, grads_bf16):
        rel = float((got.float() - want).norm() / want.norm())
        rel_arith = rel_bf16(got, want_bf16)
        log(f"  K3b {name} (bf16, tensor cores): relative Frobenius err "
            f"{rel:.3e} against float32 (bound {K3_BF16_REL}), "
            f"{rel_arith:.3e} against the bf16 arithmetic (bound "
            f"{K3_BF16_ARITH})")
        if not (rel < K3_BF16_REL and rel_arith < K3_BF16_ARITH):
            raise AssertionError(f"K3b {name} in bf16 disagrees")
    del f, out_bf16, grads_bf16

    plain_bwd = median_ms(lambda: A.attention_backward_plain(
        q, k, v, out, do, lse, scale))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out_x = A.attention_xla(*leaves)
    plain_bf16_bwd = median_ms(lambda: torch.autograd.grad(
        out_x, leaves, do, retain_graph=True))
    del out_x
    # the library's fused attention, which the port never calls: its own
    # layout is (B, H, S, D), here views of the same tensors
    lib_in = [t.transpose(1, 2) for t in leaves]
    out_l = F.scaled_dot_product_attention(*lib_in, scale=scale)
    e = float((out_l.transpose(1, 2).float() - out_p).abs().max())
    log(f"  library attention (bf16): max abs err {e:.3e} against float32")
    if not e < K3_BF16_FWD:
        raise AssertionError("the library attention disagrees: wrong views?")
    lib_det = [t.detach() for t in lib_in]
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
        *lib_det, scale=scale))
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        out_l, leaves, do.transpose(1, 2), retain_graph=True))
    del out_l

    b, s, h, d = VIT_SHAPE
    qk_flops = 2 * b * h * s * s * d  # one (S, S, D) product a (b, h)
    stats = lse  # (B, H, S) float32, as delta
    fwd = lambda: K.flash_forward_cuda(q, k, v, scale)
    dq_fn = lambda: K.flash_backward_dq_cuda(q, k, v, out, do, lse, scale)
    dkv_fn = lambda: K.flash_backward_dkv_cuda(q, k, v, do, lse, delta, scale)
    return {
        "flash_fwd": dict(  # S and P V
            max_abs_err=errs["flash_fwd"], ms=median_ms(fwd),
            device_ms=device_ms(fwd), kernel_ms=kernel_ms(fwd),
            plain_ms=median_ms(lambda: A.attention_plain(q, k, v, scale)),
            plain_bf16_ms=median_ms(lambda: A.attention_xla(q, k, v)),
            library_ms=lib_fwd,
            **bound(nbytes(q, k, v, out, stats), 2 * qk_flops, "bf16")),
        "flash_bwd_dq": dict(  # S, dP and dQ; writes dq and delta
            max_abs_err=errs["flash_bwd_dq"], ms=median_ms(dq_fn),
            device_ms=device_ms(dq_fn), kernel_ms=kernel_ms(dq_fn),
            plain_ms=plain_bwd, plain_bf16_ms=plain_bf16_bwd,
            library_ms=lib_bwd,
            **bound(nbytes(q, k, v, out, do, stats, stats, q), 3 * qk_flops,
                    "bf16")),
        "flash_bwd_dkv": dict(  # S, dP, dV and dK; reads lse and delta
            max_abs_err=errs["flash_bwd_dkv"], ms=median_ms(dkv_fn),
            device_ms=device_ms(dkv_fn), kernel_ms=kernel_ms(dkv_fn),
            plain_ms=plain_bwd, plain_bf16_ms=plain_bf16_bwd,
            library_ms=lib_bwd,
            **bound(nbytes(q, k, v, do, stats, stats, k, v), 4 * qk_flops,
                    "bf16")),
    }


def k4_kernel() -> dict:
    """K4 over 256 MiB: exact, and its time beside `Tensor.clone`'s, the
    library call of the same function (one read and one write of the array
    per copy). Device times in turns within this one call (clone, K4, K4,
    clone), 50 launches in a row each."""
    from sm3x_torch.ops import copy_cuda as K

    x = torch.randn(64 * 1024, 1024, device="cuda")
    y = K.copy_cuda(x)
    torch.cuda.synchronize()
    if not torch.equal(y, x):
        raise AssertionError("K4 copy is not exact")
    del y
    ms = median_ms(lambda: K.copy_cuda(x))
    plain_ms = median_ms(lambda: K.copy_plain(x))
    turns = [device_ms(fn) for fn in (x.clone, lambda: K.copy_cuda(x),
                                      lambda: K.copy_cuda(x), x.clone)]
    dev, lib = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    gbps = [2 * nbytes(x) / t / 1e6 for t in (dev, lib)]
    log(f"[kernels] K4 copy {tuple(x.shape)} f32 (256 MiB): exact; device "
        f"time in turns clone {turns[0]:.4f}, K4 {turns[1]:.4f}, K4 "
        f"{turns[2]:.4f}, clone {turns[3]:.4f} ms: K4 {gbps[0]:.1f} GB/s, "
        f"clone {gbps[1]:.1f} GB/s, K4 / clone {dev / lib:.4f}")
    return dict(max_abs_err=0.0, ms=ms, device_ms=dev,
                kernel_ms=kernel_ms(lambda: K.copy_cuda(x)),
                library_kernel_ms=kernel_ms(x.clone), plain_ms=plain_ms,
                library_ms=lib, turns_ms=turns, **bound(2 * nbytes(x), 0,
                                                        "f32"))


def phase_step() -> None:
    """One fp32 step of resnet18 / v32 at 64x64, batch 8, world size 2: the
    CUDA path (kernels) against the CPU path (plain versions) on the same
    weights and the same augmented views (made on the card with K1)."""
    from sm3x_torch.models.simclr import build_ssl_model
    from sm3x_torch.ops.augment import SSL_AUG, ssl_augment_batch
    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.train.backbone_train import ssl_update
    from sm3x_torch.train.common import make_adamw
    import dataclasses

    torch.manual_seed(0)
    cpu_model, style = build_ssl_model("v32", "resnet18", 32)
    gpu_model, _ = build_ssl_model("v32", "resnet18", 32)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.cuda()
    data = SyntheticPairedData(8, canvas=96, seed=4)
    cfg = dataclasses.replace(SSL_AUG, out_size=(64, 64))
    views = []
    for k, (canv, hw) in enumerate(((data.derm, data.derm_hw),
                                    (data.clinic, data.clinic_hw)) * 2):
        gen = torch.Generator(device="cuda").manual_seed(10 + k)
        views.append(ssl_augment_batch(gen, torch.from_numpy(canv).cuda(),
                                       torch.from_numpy(hw).cuda(), MEAN,
                                       STD, cfg))
    d, c = (views[0], views[2]), (views[1], views[3])
    out = {}
    for name, model, dev in (("cpu", cpu_model, "cpu"),
                             ("cuda", gpu_model, "cuda")):
        opt = make_adamw(model.parameters(), 1e-3, 5e-2, eps=1e-5)
        out[name] = ssl_update(model, opt, tuple(v.to(dev) for v in d),
                               tuple(v.to(dev) for v in c), style, 0.1, 2)
    log("[step] resnet18/v32 64x64 b8 fp32, one step, CUDA vs CPU")
    for k in ("loss", "derm", "clinic", "cross"):
        check_close(f"step {k}", out["cuda"][k], out["cpu"][k],
                    rtol=1e-4, atol=1e-5)
    worst = 0.0
    for (n, p), q in zip(gpu_model.named_parameters(),
                         cpu_model.parameters()):
        worst = max(worst, float((p.detach().cpu() - q.detach()).abs().max()))
    # Adam normalises each update to about lr, whatever the gradient's
    # size, so a near-zero gradient may flip sign between devices
    log(f"  step params: max abs diff {worst:.3e} (bound 3 x lr = 3e-3)")
    if worst > 3e-3:
        raise AssertionError("parameters after one step disagree")


def profile_steps(step, n: int, out_dir: str, name: str) -> None:
    """torch.profiler over step(0) .. step(n - 1): device time by kernel,
    per step, and the device's busy share of the host-clock window."""
    res = profile_device(step, n)
    rows, key = res["rows"], res["field"]
    busy_us = res["busy_ms"] * 1e3 * n
    log(f"[profile] {n} steps: device busy {res['busy_ms']:.1f} ms per "
        f"step of {res['wall_ms']:.1f} ms on the host clock "
        f"({100 * res['busy_ms'] / res['wall_ms']:.1f}% busy), "
        f"{res['launches']:.0f} kernels and copies a step; top kernels by "
        f"device time:")
    for e in rows[:12]:
        t = getattr(e, key)
        log(f"  {t / n / 1e3:8.3f} ms/step {100 * t / busy_us:5.1f}%  "
            f"x{e.count // n:<4d} {e.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write(res["prof"].key_averages().table(
            sort_by=key, row_limit=80, max_name_column_width=100))
    log(f"  full table: {path}")


def kernel_counters():
    """(every kernel wrapper, the three K3 wrappers), each with its
    `launches` count; K1 and K3 also count by kernel in `variants`."""
    from sm3x_torch.ops import attention_cuda as A
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.ops import copy_cuda as C
    from sm3x_torch.ops import ntxent_cuda as N

    k3 = (A.flash_forward_cuda, A.flash_backward_dq_cuda,
          A.flash_backward_dkv_cuda)
    return (K.photometric_cuda, N.ntxent_forward_cuda,
            N.ntxent_backward_cuda) + k3 + (C.copy_cuda,), k3


def reset_counters() -> None:
    counters, k3 = kernel_counters()
    for fn in counters:
        fn.launches = 0
    for fn in k3 + counters[:1]:
        fn.variants = dict.fromkeys(fn.variants, 0)


def timed_steps(steps) -> list:
    """Host-clock seconds of each step() of `steps`, each ended by a
    synchronise; a step returns its loss, which must be finite."""
    times = []
    for step in steps:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if not math.isfinite(float(loss)):
            raise AssertionError("non-finite loss in a timed step")
    return times


def phase_fit(tag: str, arch: str, batch: int, steps: int, use_checkpoint,
              per_step: dict, profile_dir=None, profile_name=None) -> dict:
    """The stage-1 trainer at the run.sh recipe with encoder `arch`: `steps`
    steps through SSLTrainer.fit with every kernel count set to 0 just
    before and read just after (each must equal `per_step` x steps), then
    the step time over two more epochs."""
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.train.backbone_train import SSLTrainer

    cfg = SSLConfig()
    m, o, r = cfg.model, cfg.optim, cfg.run
    m.arch, m.arch_version, m.proj_dim, m.temperature = (arch, "v32", 128,
                                                         0.1)
    m.use_checkpoint = use_checkpoint
    o.batch_size, o.base_lr, o.adam_eps, o.amp, o.epochs = (batch, 1e-6, 1e-5,
                                                            True, 1)
    cfg.data.img_sz, cfg.data.mean, cfg.data.std = (224, 224), MEAN, STD
    r.world_size, r.device, r.print_freq = 2, "cuda", 10 ** 6
    r.log_path = os.path.join(LOGS, tag)
    shutil.rmtree(r.log_path, ignore_errors=True)

    data = SyntheticPairedData(batch * steps, canvas=320, seed=0)
    trainer = SSLTrainer(cfg)
    counters, k3 = kernel_counters()
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = trainer.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    variants = {fn.__name__: dict(fn.variants) for fn in k3}
    k1_variants = dict(K.photometric_cuda.variants)
    peak = torch.cuda.max_memory_allocated()
    losses = hist[0]["step_losses"]
    log(f"[{tag}] stage-1 step: {arch}/v32, proj 128, T 0.1, batch {batch}, "
        f"world size 2, bf16 autocast, 224x224, --use-checkpoint "
        f"{trainer.remat}; {steps} steps via SSLTrainer.fit in {wall:.2f} s")
    log(f"  losses per step: {losses}")
    log(f"  kernel launches in fit: {launches}")
    log(f"  K1 launches by kernel (band: one read and one write of each "
        f"image; scratch: the general-shape path): {k1_variants}")
    log(f"  K3 launches by kernel (fma float32, mma bf16): {variants}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {steps} finite losses, got {losses}")
    want = {fn.__name__: per_step.get(fn.__name__, 0) * steps
            for fn in counters}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    # 224 x 224: every K1 launch is the band kernel
    if k1_variants != {"band": launches["photometric_cuda"], "scratch": 0}:
        raise AssertionError(f"K1 kernels {k1_variants}, expected band only")
    # bf16 autocast: every K3 launch is a tensor-core kernel
    if any(v != {"fma": 0, "mma": launches[n]} for n, v in variants.items()):
        raise AssertionError(f"K3 kernels {variants}, expected mma only")
    if not os.path.exists(os.path.join(r.log_path, "ckp_0.pth")):
        raise AssertionError("fit wrote no ckp_0.pth")

    def device_batches(epoch):
        return [[torch.from_numpy(x).cuda() for x in
                 (b.derm, b.derm_hw, b.clinic, b.clinic_hw)]
                for b in data.batches(batch, epoch, cfg.run.seed)]

    # step time: two more epochs of the same trainer, each step ended by a
    # sync
    times = timed_steps([
        lambda it=it, args=args: trainer.train_step(*args, it)["loss"]
        for it, args in enumerate(device_batches(1) + device_batches(2))])
    step_s = statistics.median(times)
    log(f"  step time: median {step_s * 1e3:.1f} ms over {len(times)} steps, "
        f"min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f} (host "
        f"clock, synchronised; canvases uploaded before the clock); "
        f"{4 * batch / step_s:.1f} images/s (4 x batch per step)")
    log(f"  peak device memory in fit: {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    if profile_dir:
        batches = device_batches(3)[:3]
        profile_steps(lambda it: trainer.train_step(*batches[it], it),
                      len(batches), profile_dir, profile_name)
    return launches


# kernel launches a step on each path, by wrapper
MAIN_PER_STEP = {"photometric_cuda": 4, "ntxent_forward_cuda": 1,
                 "ntxent_backward_cuda": 1}
VIT_PER_STEP = dict(MAIN_PER_STEP, flash_forward_cuda=48,
                    flash_backward_dq_cuda=48, flash_backward_dkv_cuda=48)


def phase_main(profile_dir=None) -> dict:
    return phase_fit("main", "resnet50", MAIN_BATCH, MAIN_STEPS, False,
                     MAIN_PER_STEP, profile_dir, "profile_step.txt")


def phase_vit(profile_dir=None) -> dict:
    """vit_b16 with --use-checkpoint flash: 12 blocks x 4 encoder passes
    give 48 launches of each K3 kernel a step."""
    return phase_fit("vit", "vit_b16", VIT_BATCH, VIT_STEPS, "flash",
                     VIT_PER_STEP, profile_dir, "profile_vit.txt")


# stage 2 at run.sh's recipe: 1024 synthetic cases, 4 steps an epoch
STAGE2_BATCH, STAGE2_CASES, STAGE2_EPOCHS = 256, 1024, 2
STAGE2_PER_STEP = {"photometric_cuda": 2}


def phase_stage2(profile_dir=None) -> dict:
    """The stage-2 trainer at the run.sh recipe (resnet50, 224x224, batch
    256, v4 projectors of 512, 1 head, ff 128, dropout 0.1, T 1, lr 1e-4,
    float32 with TF32 off) from the ckp_0.pth that [main] wrote: the init
    pass and `MLCTrainer.fit` over 2 epochs with every kernel count set to
    0 just before and read just after, the checks on what they leave, then
    the times of the init pass, of an epoch's k-means and of 8 more steps."""
    from sm3x_torch import NUM_CLASSES
    from sm3x_torch.core import prng
    from sm3x_torch.core.config import MLCTrainConfig
    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.ops.kmeans import spherical_kmeans
    from sm3x_torch.train import mlc_train

    cfg = MLCTrainConfig()
    m, o, r = cfg.model, cfg.optim, cfg.run
    m.arch, m.mlc_proj, m.mlc_proj_dim, m.num_heads = "resnet50", "v4", 512, 1
    m.sa_dim_ff, m.sa_dropout, m.temperature = 128, 0.1, 1.0
    o.batch_size, o.base_lr, o.amp, o.epochs = (STAGE2_BATCH, 1e-4, False,
                                                STAGE2_EPOCHS)
    cfg.data.img_sz, cfg.data.mean, cfg.data.std = (224, 224), MEAN, STD
    r.device, r.print_freq = "cuda", 10 ** 6
    r.log_path = os.path.join(LOGS, "stage2")
    shutil.rmtree(r.log_path, ignore_errors=True)
    cfg.extractor_weights = os.path.join(LOGS, "main", "ckp_0.pth")

    data = SyntheticPairedData(STAGE2_CASES, canvas=320, seed=1)
    steps = data.steps_per_epoch(STAGE2_BATCH)
    trainer = mlc_train.MLCTrainer(
        cfg, extractor_state=mlc_train.load_extractor_state(
            cfg.extractor_weights))
    extractor = trainer.model.extractor

    def snapshot():
        return {k: v.clone() for k, v in extractor.state_dict().items()}

    def statistic(k):
        return "running" in k or "num_batches" in k

    loaded = snapshot()
    counters, _ = kernel_counters()
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.init_memory(data)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = K.photometric_cuda.launches
    after_init = snapshot()
    t0 = time.perf_counter()
    hist = trainer.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    k1_variants = dict(K.photometric_cuda.variants)
    peak = torch.cuda.max_memory_allocated()
    after_fit = snapshot()

    losses = [h["step_losses"] for h in hist]
    log(f"[stage2] DeepCluster step: resnet50 frozen, v4 / 512, 1 head, ff "
        f"128, dropout 0.1, T 1, batch {STAGE2_BATCH}, float32 (TF32 off), "
        f"224x224, {STAGE2_CASES} cases; init pass of {steps} batches in "
        f"{init_s:.2f} s, {STAGE2_EPOCHS} epochs of {steps} steps via "
        f"MLCTrainer.fit in {wall:.2f} s")
    log(f"  losses per step: {losses}")
    log(f"  kernel launches in the init pass and fit: {launches}; K1 in the "
        f"init pass {init_launches}; K1 by kernel {k1_variants}")
    if [len(x) for x in losses] != [steps] * STAGE2_EPOCHS or not all(
            math.isfinite(x) for ep in losses for x in ep):
        raise AssertionError(f"expected {STAGE2_EPOCHS} x {steps} finite "
                             f"losses, got {losses}")
    passes = steps * (1 + STAGE2_EPOCHS)  # init batches and train steps
    want = {fn.__name__: STAGE2_PER_STEP.get(fn.__name__, 0) * passes
            for fn in counters}
    if launches != want or init_launches != 2 * steps:
        raise AssertionError(f"launch counts {launches} (init pass "
                             f"{init_launches}), expected {want}")
    if k1_variants != {"band": launches["photometric_cuda"], "scratch": 0}:
        raise AssertionError(f"K1 kernels {k1_variants}, expected band only")
    for i, k in enumerate(NUM_CLASSES):
        a = trainer.assignments[i]
        if a.shape != (STAGE2_CASES,) or int(a.min()) < 0 or int(a.max()) >= k:
            raise AssertionError(f"label {i}: assignments outside [0, {k})")
    # the frozen extractor: weights as loaded, bit for bit; running
    # statistics moved by the init pass and by nothing after
    weights_same = all(torch.equal(after_fit[k], v) for k, v in loaded.items()
                       if not statistic(k))
    moved = sum(not torch.equal(after_init[k], v) for k, v in loaded.items()
                if statistic(k))
    stats_kept = all(torch.equal(after_fit[k], v)
                     for k, v in after_init.items())
    n_stats = sum(statistic(k) for k in loaded)
    log(f"  extractor after fit: weights bit-identical to the checkpoint "
        f"{weights_same}; running statistics moved by the init pass "
        f"{moved} of {n_stats}, unchanged since {stats_kept}")
    if not (weights_same and moved == n_stats and stats_kept):
        raise AssertionError("the frozen extractor changed")
    if not os.path.exists(os.path.join(r.log_path, "ckp_1.pth")):
        raise AssertionError("fit wrote no ckp_1.pth")

    # an epoch's clustering alone: its time, and what it leaves in the
    # prototypes (the unit-norm centroids of the same seeded k-means, whose
    # E-step the assignments are)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.cluster(STAGE2_EPOCHS)
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    seed = prng.fold_in(prng.fold_in(r.seed, STAGE2_EPOCHS),
                        mlc_train.KMEANS_STREAM)
    worst_norm = 0.0
    for i, k in enumerate(NUM_CLASSES):
        w = trainer.model.prototypes[i].weight.detach()
        cent, a = spherical_kmeans(
            trainer.bank[i], k, cfg.kmeans_iters,
            generator=prng.generator(prng.fold_in(seed, i), "cuda"))
        if not (torch.equal(w, cent) and torch.equal(
                trainer.assignments[i], a)):
            raise AssertionError(f"label {i}: the prototype weights are not "
                                 f"the centroids of its clustering")
        worst_norm = max(worst_norm,
                         float((w.norm(dim=1) - 1).abs().max()))
    log(f"  k-means of an epoch (8 labels, {cfg.kmeans_iters} iterations, "
        f"{STAGE2_CASES} x 512 bank rows): {kmeans_s * 1e3:.1f} ms; each "
        f"prototype weight equals its centroid, | norm - 1 | <= "
        f"{worst_norm:.2e}")
    if worst_norm > 1e-5:
        raise AssertionError("centroids are not of unit norm")

    def device_batches(epoch):
        return [[torch.from_numpy(x).cuda() for x in
                 (b.derm, b.derm_hw, b.clinic, b.clinic_hw)]
                + [torch.from_numpy(b.index).cuda().long()]
                for b in data.batches(STAGE2_BATCH, epoch, r.seed)]

    def step(args, it):
        return trainer.train_step(trainer.bank, *args, trainer.assignments, it)

    times = timed_steps([lambda it=it, args=args: step(args, it)
                         for it, args in enumerate(device_batches(2)
                                                   + device_batches(3))])
    step_s = statistics.median(times)
    log(f"  step time: median {step_s * 1e3:.1f} ms over {len(times)} steps, "
        f"min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f} (host "
        f"clock, synchronised; canvases uploaded before the clock); "
        f"{2 * STAGE2_BATCH / step_s:.1f} images/s (2 x batch per step); "
        f"the init pass {init_s / steps * 1e3:.1f} ms a batch, uploads "
        f"included")
    log(f"  peak device memory in the init pass and fit: "
        f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated)")
    if profile_dir:
        batches = device_batches(4)[:3]
        profile_steps(lambda it: step(batches[it], it), len(batches),
                      profile_dir, "profile_stage2.txt")
    return launches


def phase_copy() -> dict:
    """K4's own entry point, tools/bench_copy_torch.py, at its defaults."""
    import importlib.util

    from sm3x_torch.ops import copy_cuda as C

    spec = importlib.util.spec_from_file_location(
        "bench_copy_torch", os.path.join(ROOT, "tools", "bench_copy_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    C.copy_cuda.launches = 0
    log("[copy] tools/bench_copy_torch.py 256 50")
    tool.main(["256", "50"])
    log(f"  kernel launches: copy_cuda {C.copy_cuda.launches}")
    if C.copy_cuda.launches != 52:  # 2 warm-up + 50 timed
        raise AssertionError("the copy tool did not run K4 52 times")
    return {"copy_cuda": C.copy_cuda.launches}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="also profile three steps of the main, stage2 and "
                   "vit phases and write the tables to DIR")
    args = p.parse_args(argv)
    import sm3x_torch  # noqa: F401  fails outside a checkout of the repo

    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kernels, floor = phase_kernels()
    phase_step()
    launches = phase_main(args.profile)
    stage2_launches = phase_stage2(args.profile)
    vit_launches = phase_vit(args.profile)
    copy_launches = phase_copy()
    for mod in ("jax", "sm3x"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")

    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    # name: source, TPU kernel replaced, counter, the path's launch counts
    meta = {
        "photometric": ("sm3x_torch/csrc/photometric.cu",
                        "sm3x/ops/augment_pallas.py:162", "photometric_cuda",
                        launches),
        "ntxent_fwd": ("sm3x_torch/csrc/ntxent.cu",
                       "sm3x/ops/ntxent_pallas.py:77", "ntxent_forward_cuda",
                       launches),
        "ntxent_bwd": ("sm3x_torch/csrc/ntxent.cu",
                       "sm3x/ops/ntxent_pallas.py:91", "ntxent_backward_cuda",
                       launches),
        "flash_fwd": ("sm3x_torch/csrc/flash_attention_fwd_mma.cu",
                      f"sm3x/models/vit.py:85 ({flash}:758)",
                      "flash_forward_cuda", vit_launches),
        "flash_bwd_dkv": ("sm3x_torch/csrc/flash_attention_bwd_mma.cu",
                          f"sm3x/models/vit.py:85 ({flash}:1121)",
                          "flash_backward_dkv_cuda", vit_launches),
        "flash_bwd_dq": ("sm3x_torch/csrc/flash_attention_bwd_mma.cu",
                         f"sm3x/models/vit.py:85 ({flash}:1456)",
                         "flash_backward_dq_cuda", vit_launches),
        "copy": ("sm3x_torch/csrc/copy.cu", "tools/bench_pallas_io.py:44",
                 "copy_cuda", copy_launches),
    }
    shutil.rmtree(LOGS, ignore_errors=True)
    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=counts[counter],
                 launches_stage2=stage2_launches[counter],
                 launches_per_step={"main": MAIN_PER_STEP.get(counter, 0),
                                    "vit": VIT_PER_STEP.get(counter, 0),
                                    "stage2": STAGE2_PER_STEP.get(counter, 0)},
                 **kernels[name])
            for name, (src, rep, counter, counts) in meta.items()]
    log(json.dumps({"kernels": rows, **floor}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
