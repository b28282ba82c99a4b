#!/usr/bin/env python
"""Smoke run of the PyTorch port (sm3x_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card

Phases, each printing its lines:
  device   the card's name and power limit (fails without CUDA)
  build    nvcc builds sm3x_torch/csrc/*.cu (seconds, ptxas register use)
  kernels  K1 (photometric), K2f / K2b (NT-Xent), K3f / K3b-dq / K3b-dkv
           (flash attention) and K4 (copy) against their plain PyTorch
           versions on the card, in float32 with TF32 off, at the stage-1
           shapes (K3 also in bf16 at ViT-B's (64, 197, 12, 64), where K3b
           runs on the tensor cores and is held against the plain backward
           in float32 and in the TPU kernel's bf16 arithmetic; K4 over 256
           MiB, exact); median time of each beside the plain version's, and
           for K3 also beside the plain attention in bf16 on the tensor
           cores (`attention_xla` and its autograd backward)
  step     one fp32 step of a small model on the card against the same step
           on the CPU (plain versions), from the same weights and views
  main     the stage-1 trainer at the run.sh recipe (resnet50, v32, proj 128,
           T 0.1, global batch 96, --world-size 2, lr 1e-6, AdamW eps 1e-5,
           bf16 autocast, 224x224) over in-memory synthetic canvases: per-step
           losses, kernel launch counts, step time, images/s, peak memory
  vit      the same trainer with a ViT-B/16 encoder pair (vit_b16, v32, proj
           128, T 0.1, batch 64, --world-size 2, bf16 autocast, 224x224,
           --use-checkpoint flash): attention through K3 forward and
           backward, 48 launches of each a step, every K3b launch the
           tensor-core kernel; losses, launch counts, step time, images/s,
           peak memory
  copy     tools/bench_copy_torch.py (K4 against `x + 1`, GB/s)

With `--profile DIR`, the main and vit phases also trace three more steps
with torch.profiler and write the device-time tables to
DIR/profile_step.txt and DIR/profile_vit.txt.

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
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

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
VIT_SHAPE = (64, 197, 12, 64)            # ViT-B/16 at 224, batch 64
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


def median_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() over reps calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on an NVIDIA GPU only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    from sm3x_torch.ops import _native

    _native.library()
    regs = [ln.strip() for ln in _native.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"[build] nvcc {_native.nvcc_path()}: {_native.build_seconds:.1f} s "
        f"(0.0 = library already built)")
    for ln in regs:
        log(f"  ptxas {ln}")


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


def phase_kernels() -> dict:
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.ops import ntxent_cuda as N

    results = {}
    images, params = k1_inputs()
    got = K.photometric_cuda(images, params, MEAN, STD)
    want = K.photometric_plain(images, params, MEAN, STD)
    torch.cuda.synchronize()
    log(f"[kernels] K1 photometric {tuple(images.shape)}")
    err = check_close("K1 out", got, want, **K1_TOL)
    results["photometric"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: K.photometric_cuda(images, params, MEAN, STD)),
        plain_ms=median_ms(
            lambda: K.photometric_plain(images, params, MEAN, STD)))

    errs = {"fwd": 0.0, "bwd": 0.0}
    rng = np.random.default_rng(3)
    for shape in ((8, 96, 128), (4, 256, 128)):
        z = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
        g = torch.from_numpy(rng.random(shape[0], dtype=np.float32)).cuda()
        loss, lse, inv = N.ntxent_forward_cuda(z, 0.1)
        loss_p, lse_p, inv_p = N.ntxent_forward_plain(z, 0.1)
        dz = N.ntxent_backward_cuda(z, lse, inv, g, 0.1)
        dz_p = N.ntxent_backward_plain(z, lse_p, inv_p, g, 0.1)
        # the plain backward through autograd of the plain forward
        zr = z.clone().requires_grad_(True)
        (N.ntxent_forward_plain(zr, 0.1)[0] * g).sum().backward()
        torch.cuda.synchronize()
        log(f"[kernels] K2 ntxent z {shape}")
        errs["fwd"] = max(errs["fwd"], check_close("K2f loss", loss, loss_p,
                                                   **K2F_TOL))
        errs["bwd"] = max(errs["bwd"], check_close("K2b dz", dz, dz_p,
                                                   **K2B_TOL))
        check_close("plain dz vs autograd", dz_p, zr.grad, **K2B_TOL)
        if shape == (8, 96, 128):  # the stage-1 shape: 4 terms x 2 groups
            results["ntxent_fwd"] = dict(
                ms=median_ms(lambda: N.ntxent_forward_cuda(z, 0.1)),
                plain_ms=median_ms(lambda: N.ntxent_forward_plain(z, 0.1)))
            results["ntxent_bwd"] = dict(
                ms=median_ms(lambda: N.ntxent_backward_cuda(
                    z, lse, inv, g, 0.1)),
                plain_ms=median_ms(lambda: N.ntxent_backward_plain(
                    z, lse_p, inv_p, g, 0.1)))
    results["ntxent_fwd"]["max_abs_err"] = errs["fwd"]
    results["ntxent_bwd"]["max_abs_err"] = errs["bwd"]
    results.update(k3_kernels())
    results["copy"] = k4_kernel()
    for name, r in results.items():
        bf16 = (f", plain bf16 {r['plain_bf16_ms']:.4f} ms"
                if "plain_bf16_ms" in r else "")
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
            f"{bf16} (median of 20, CUDA events)")
    return results


def k3_kernels() -> dict:
    """K3f, K3b-dq and K3b-dkv against the plain forward and analytic
    backward: float32 at a small ragged shape and at ViT-B's (K3b on the
    FMA kernels), and bf16 at ViT-B's (K3b on the tensor cores) against the
    plain float32 version on the same bf16 inputs and against the plain
    backward in bf16 arithmetic on the kernels' own out and lse. The times
    are those of the bf16 launches, the slice's; the plain time of both
    backward kernels is the whole plain backward, which computes dq, dk and
    dv together: `plain_ms` in float32 (the analytic backward), and
    `plain_bf16_ms` as `--use-checkpoint off` runs attention, in bf16 on
    the tensor cores (`attention_xla`, and its autograd backward replayed
    on one graph). max_abs_err is the largest of the float32 checks and,
    for K3f, of the bf16 forward."""
    from sm3x_torch.ops import attention as A
    from sm3x_torch.ops import attention_cuda as K

    rng = np.random.default_rng(5)

    def run(shape, dtype):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).cuda().to(dtype) for _ in range(4))
        scale = 1.0 / math.sqrt(shape[3])
        k3b = (K.flash_backward_dq_cuda, K.flash_backward_dkv_cuda)
        kind = "mma" if dtype == torch.bfloat16 else "fma"
        before = [fn.variants[kind] for fn in k3b]
        out, lse = K.flash_forward_cuda(q, k, v, scale)
        dq, delta = K.flash_backward_dq_cuda(q, k, v, out, do, lse, scale)
        dk, dv = K.flash_backward_dkv_cuda(q, k, v, do, lse, delta, scale)
        if [fn.variants[kind] for fn in k3b] != [n + 1 for n in before]:
            raise AssertionError(f"K3b in {dtype} did not run its {kind} "
                                 f"kernels")
        f = [t.float() for t in (q, k, v, do)]
        out_p, lse_p = A.attention_plain(*f[:3], scale)
        grads_p = A.attention_backward_plain(*f[:3], out_p, f[3], lse_p,
                                             scale)
        torch.cuda.synchronize()
        log(f"[kernels] K3 flash attention {shape} "
            f"{str(dtype).replace('torch.', '')} (K3b: {kind} kernels)")
        return ((q, k, v, do, scale), (out, lse, delta),
                zip(("dq", "dk", "dv"), (dq, dk, dv), grads_p), (out_p, lse_p))

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

    (q, k, v, do, scale), (out, lse, delta), grads, (out_p, _) = run(
        VIT_SHAPE, torch.bfloat16)
    e = float((out.float() - out_p).abs().max())
    log(f"  K3f out (bf16): max abs err {e:.3e} (bound {K3_BF16_FWD})")
    if not e < K3_BF16_FWD:
        raise AssertionError("K3f in bf16 disagrees with its plain version")
    errs["flash_fwd"] = max(errs["flash_fwd"], e)
    f = [t.float() for t in (q, k, v, do)]
    grads_bf16 = A.attention_backward_plain(
        *f[:3], out.float(), f[3], lse, scale, operand_dtype=torch.bfloat16)
    for (name, got, want), want_bf16 in zip(grads, grads_bf16):
        rel = float((got.float() - want).norm() / want.norm())
        want_bf16 = want_bf16.bfloat16().float()
        rel_bf16 = float((got.float() - want_bf16).norm() / want_bf16.norm())
        log(f"  K3b {name} (bf16, tensor cores): relative Frobenius err "
            f"{rel:.3e} against float32 (bound {K3_BF16_REL}), {rel_bf16:.3e} "
            f"against the bf16 arithmetic (bound {K3_BF16_ARITH})")
        if not (rel < K3_BF16_REL and rel_bf16 < K3_BF16_ARITH):
            raise AssertionError(f"K3b {name} in bf16 disagrees")
    plain_bwd = median_ms(lambda: A.attention_backward_plain(
        q, k, v, out, do, lse, scale))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out_x = A.attention_xla(*leaves)
    plain_bf16_bwd = median_ms(lambda: torch.autograd.grad(
        out_x, leaves, do, retain_graph=True))
    return {
        "flash_fwd": dict(
            max_abs_err=errs["flash_fwd"],
            ms=median_ms(lambda: K.flash_forward_cuda(q, k, v, scale)),
            plain_ms=median_ms(lambda: A.attention_plain(q, k, v, scale)),
            plain_bf16_ms=median_ms(lambda: A.attention_xla(q, k, v))),
        "flash_bwd_dq": dict(
            max_abs_err=errs["flash_bwd_dq"],
            ms=median_ms(lambda: K.flash_backward_dq_cuda(
                q, k, v, out, do, lse, scale)),
            plain_ms=plain_bwd, plain_bf16_ms=plain_bf16_bwd),
        "flash_bwd_dkv": dict(
            max_abs_err=errs["flash_bwd_dkv"],
            ms=median_ms(lambda: K.flash_backward_dkv_cuda(
                q, k, v, do, lse, delta, scale)),
            plain_ms=plain_bwd, plain_bf16_ms=plain_bf16_bwd),
    }


def k4_kernel() -> dict:
    """K4 over 256 MiB: exact, and its GB/s beside clone's (one read and
    one write of the array per copy)."""
    from sm3x_torch.ops import copy_cuda as K

    x = torch.randn(64 * 1024, 1024, device="cuda")
    y = K.copy_cuda(x)
    torch.cuda.synchronize()
    if not torch.equal(y, x):
        raise AssertionError("K4 copy is not exact")
    ms = median_ms(lambda: K.copy_cuda(x))
    plain_ms = median_ms(lambda: K.copy_plain(x))
    gbps = [2 * x.numel() * 4 / t / 1e6 for t in (ms, plain_ms)]
    log(f"[kernels] K4 copy {tuple(x.shape)} f32 (256 MiB): exact; "
        f"{gbps[0]:.1f} GB/s, clone {gbps[1]:.1f} GB/s")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)


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


def profile_steps(trainer, batches, out_dir: str, name: str) -> None:
    """torch.profiler over the given steps: device time by kernel, per
    step, and the device's busy share of the host-clock window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it, args in enumerate(batches):
            trainer.train_step(*args, it)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0],
           "self_device_time_total") else "self_cuda_time_total")
    # kernels only: an op's row, and a range such as the optimizer step's
    # user annotation, repeat the time of the kernels inside them
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -getattr(e, key))
    busy_us = sum(getattr(e, key) for e in kernels)
    n = len(batches)
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    launches = sum(e.count for e in kernels) / n
    log(f"[profile] {n} steps: device busy {busy_us / n / 1e3:.1f} ms per "
        f"step of {wall_us / n / 1e3:.1f} ms on the host clock "
        f"({100 * busy_us / wall_us:.1f}% busy), {launches:.0f} kernels and "
        f"copies a step; top kernels by device time:")
    for e in kernels[:12]:
        t = getattr(e, key)
        log(f"  {t / n / 1e3:8.3f} ms/step {100 * t / busy_us:5.1f}%  "
            f"x{e.count // n:<4d} {e.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write(events.table(sort_by=key, row_limit=80,
                             max_name_column_width=100))
    log(f"  full table: {path}")


def phase_fit(tag: str, arch: str, batch: int, steps: int, use_checkpoint,
              per_step: dict, profile_dir=None, profile_name=None) -> dict:
    """The stage-1 trainer at the run.sh recipe with encoder `arch`: `steps`
    steps through SSLTrainer.fit with every kernel count set to 0 just
    before and read just after (each must equal `per_step` x steps), then
    the step time over 8 more steps."""
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.ops import attention_cuda as A
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.ops import copy_cuda as C
    from sm3x_torch.ops import ntxent_cuda as N
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
    r.log_path = os.path.join(ROOT, "build", "chip_smoke_logs")
    shutil.rmtree(r.log_path, ignore_errors=True)

    data = SyntheticPairedData(batch * steps, canvas=320, seed=0)
    trainer = SSLTrainer(cfg)
    counters = (K.photometric_cuda, N.ntxent_forward_cuda,
                N.ntxent_backward_cuda, A.flash_forward_cuda,
                A.flash_backward_dq_cuda, A.flash_backward_dkv_cuda,
                C.copy_cuda)
    k3b = (A.flash_backward_dq_cuda, A.flash_backward_dkv_cuda)
    for fn in counters:
        fn.launches = 0
    for fn in k3b:
        fn.variants = dict.fromkeys(fn.variants, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = trainer.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    variants = {fn.__name__: dict(fn.variants) for fn in k3b}
    peak = torch.cuda.max_memory_allocated()
    losses = hist[0]["step_losses"]
    log(f"[{tag}] stage-1 step: {arch}/v32, proj 128, T 0.1, batch {batch}, "
        f"world size 2, bf16 autocast, 224x224, --use-checkpoint "
        f"{trainer.remat}; {steps} steps via SSLTrainer.fit in {wall:.2f} s")
    log(f"  losses per step: {losses}")
    log(f"  kernel launches in fit: {launches}")
    log(f"  K3b launches by kernel (fma float32, mma bf16): {variants}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {steps} finite losses, got {losses}")
    want = {fn.__name__: per_step.get(fn.__name__, 0) * steps
            for fn in counters}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    # bf16 autocast: every K3b launch is the tensor-core kernel
    if any(v != {"fma": 0, "mma": launches[n]} for n, v in variants.items()):
        raise AssertionError(f"K3b kernels {variants}, expected mma only")
    if not os.path.exists(os.path.join(r.log_path, "ckp_0.pth")):
        raise AssertionError("fit wrote no ckp_0.pth")

    def device_batches(epoch):
        return [[torch.from_numpy(x).cuda() for x in
                 (b.derm, b.derm_hw, b.clinic, b.clinic_hw)]
                for b in data.batches(batch, epoch, cfg.run.seed)]

    # step time: two more epochs of the same trainer, each step ended by a
    # sync
    times = []
    for it, args in enumerate(device_batches(1) + device_batches(2)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = trainer.train_step(*args, it)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError("non-finite loss in a timed step")
    step_s = statistics.median(times)
    log(f"  step time: median {step_s * 1e3:.1f} ms over {len(times)} steps, "
        f"min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f} (host "
        f"clock, synchronised; canvases uploaded before the clock); "
        f"{4 * batch / step_s:.1f} images/s (4 x batch per step)")
    log(f"  peak device memory in fit: {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    if profile_dir:
        profile_steps(trainer, device_batches(3)[:3], profile_dir,
                      profile_name)
    shutil.rmtree(r.log_path, ignore_errors=True)
    return launches


def phase_main(profile_dir=None) -> dict:
    return phase_fit("main", "resnet50", MAIN_BATCH, MAIN_STEPS, False,
                     {"photometric_cuda": 4, "ntxent_forward_cuda": 1,
                      "ntxent_backward_cuda": 1},
                     profile_dir, "profile_step.txt")


def phase_vit(profile_dir=None) -> dict:
    """vit_b16 with --use-checkpoint flash: 12 blocks x 4 encoder passes
    give 48 launches of each K3 kernel a step."""
    return phase_fit("vit", "vit_b16", VIT_BATCH, VIT_STEPS, "flash",
                     {"photometric_cuda": 4, "ntxent_forward_cuda": 1,
                      "ntxent_backward_cuda": 1, "flash_forward_cuda": 48,
                      "flash_backward_dq_cuda": 48,
                      "flash_backward_dkv_cuda": 48},
                     profile_dir, "profile_vit.txt")


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
                   help="also profile three steps of the main and vit "
                   "phases and write the tables to DIR")
    args = p.parse_args(argv)
    import sm3x_torch  # noqa: F401  fails outside a checkout of the repo

    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kernels = phase_kernels()
    phase_step()
    launches = phase_main(args.profile)
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
        "flash_fwd": ("sm3x_torch/csrc/flash_attention.cu",
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
    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=counts[counter], **kernels[name])
            for name, (src, rep, counter, counts) in meta.items()]
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
