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
           with the kernel each shape took, and at the supervised stages'
           (128, 224, 224, 3) with parameter rows of the finetune preset:
           flip and normalise only; K2 also at --proj-dim 640, at
           rows that stream several tiles and at an odd D off the 16-byte
           copies; K1, K2f and K2b twice for identical bits; K3 also in bf16 at ViT-B's (64, 197, 12, 64), where it
           runs on the tensor cores and is held against the plain versions
           in float32 and in the TPU kernels' bf16 arithmetic; K4 over 256
           MiB, exact; and at the multi-crop and tri-modal paths' shapes:
           K1 at (576, 96, 96, 3), which must take the band kernel, K2f /
           K2b at (32, 96, 128) and (18, 64, 128), K3 at (64, 37, 12, 64)
           in float32 and bf16 beside the library's attention, each row
           under `path_shapes` of its kernel). Times of each: `ms`, the median of 20 single
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
           on the CPU (plain versions), from the same weights and views:
           resnet18 at 64x64, then vit_t16 (--use-checkpoint flash, K3 in
           float32) under multi-crop, 32x32 globals and 16x16 locals
  main     the stage-1 trainer at the run.sh recipe (resnet50, v32, proj 128,
           T 0.1, global batch 96, --world-size 2, lr 1e-6, AdamW eps 1e-5,
           bf16 autocast, 224x224) over in-memory synthetic canvases: per-step
           losses, kernel launch counts (K1's by kernel: every launch at
           224x224 must take the band kernel), step time, images/s, peak
           memory; the step is a CUDA graph from the second step, so each
           kernel's launches in a device trace of three more steps are held
           against the host's counts
  crop     `main`'s recipe under --data-name SevenPCSwavDataset at the CLI's
           multi-crop defaults (2 x 224 at scales 0.5-1 and 6 x 96 at
           0.14-0.5 a modality, local weight 1.0): 3 steps through fit, K1
           4 launches a step (each crop group of a modality in one: the
           two globals, the six locals; all band), K2f / K2b one each (16
           terms x 2 groups); step times, the device's busy time of three
           traced steps, the loss's parts, peak memory
  bnfreq   `main`'s recipe under --bn-stat-freq 4 (EXPERIMENTAL,
           off-recipe): 8 steps through fit, 2 standard and 6 fast (the
           model in eval mode), K1 4, K2f 1 and K2b 1 launches a step (all
           band); a fast step leaves every running statistic bit-identical
           and the model in train mode, a standard step moves them; each
           step's device busy ms and launches over three traced steps and
           its host-clock median over six steps in turns
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
  eval     the supervised finetune of stage 2's model at the run.sh recipe
           (stage2_eval: the ckp_1.pth that `stage2` wrote, batch 128, lr
           1e-3, --finetune projector, v4 / 512, 1 head, ff 128, float32 with
           TF32 off) over 1024 train and 256 test synthetic cases with
           labels: one epoch through MLCEvalTrainer.fit and results.csv; the
           checkpoint lacks only the prototype biases, K1 launched twice a
           train step (band kernel) and never in an eval step, the extractor
           bit-identical to the checkpoint, best_eval.pth written once after
           the loop, the released CSV header and finite cells, a train
           step's predictions equal to a second forward on the same views;
           then two steps of --finetune all at batch 64 (stem frozen, its
           statistics moving); step and eval-batch times, device busy time,
           launches, peak memory
  probe    the backbone linear eval at the run.sh recipe (stage1_eval: the
           two encoders of `main`'s ckp_0.pth under 8 linear heads, batch
           128, lr 1e-3, --finetune fc, bf16 autocast): one epoch through
           BackboneEvalTrainer.fit and results.csv; backbones bit-identical
           afterwards; the same numbers
  transfer the ISIC transfer probe on a synthetic ISIC17 tree that the
           script writes (256 train / 64 test JPEGs of 100-370 pixels a
           side), from `main`'s ckp_0.pth: the resnet50 derm encoder frozen
           under two binary heads, batch 64, 2 epochs, bf16 autocast; K1
           once a train batch (band), ms an epoch, AUC_AVG finite in [0, 1],
           peak memory
  infer    sm3x_torch.api on `eval`'s best_eval.pth: build_evaluator,
           load_weights, predict_fn at batch 1 and 64, at the default bf16
           (the encoders under bf16 autocast, the head float32, as the JAX
           package's dtype=jnp.bfloat16) and in float32 (amp=False): float32
           equal to the trainer's eval step on the same images and to the
           same forward on the CPU, bf16 within BF16_LOGITS_REL /
           BF16_PROB_ATOL of the eval step, and a planted fault (the head
           in bf16 too) outside them; latency a call of each
  serve    sm3x_torch.serve.Predictor on `eval`'s best_eval.pth (two
           resnet50, 224x224, canvas 320, buckets 1 / 8 / 32 / 128, TF32
           off), float32 (amp=False) and then at its default, bf16: a CUDA
           graph a bucket in one memory pool, autocast's weight cache off
           while capturing; requests of 1, 5, 8, 33 and 300 cases of raw
           uint8 images against the eager forward on the same canvases,
           rows summing to 1, latency at 1 / 8 / 32 / 128 cases and the
           pool's size; a padded request against the case alone, the 300
           against its chunks, one device-to-host copy a dispatch
           (torch.profiler), and the HTTP server on 127.0.0.1: /healthz,
           /labels, 400, 413, 16 threads through the batcher, POST /predict
           where PIL or cv2 is there, stop(); each leg at its own bound
           (SERVE_BATCH_TOL), over cases whose rows lie further apart
           than it and the error read; then bf16 probabilities against
           float32
  export   sm3x_torch.export on `eval`'s best_eval.pth: the CLI at its
           defaults (bf16, buckets 1 / 8 / 32, on the card), each bucket's
           export and write seconds and MB; a float32 artifact of bucket 8
           and one for the CPU, which ExportedPredictor must refuse on the
           card; a fresh interpreter (--export-worker) loads the artifacts
           with no model code imported (load and capture seconds, a CUDA
           graph a bucket, the stem weight's strides) and serves 1 / 8 /
           32 / 37 cases, held against the live Predictor on the same
           images at [serve]'s bounds between batches (bf16 atol 1e-4,
           float32 rtol 1e-4 / atol 1e-5), and its graphs' pool beside the
           live Predictor's; upload + replay + fetch and busy ms at 1 / 8 /
           32 cases of the artifact and the live Predictor in this process,
           in turns; `python -m sm3x_torch.serve_http --exported-path` on
           127.0.0.1 answers a POST of two PNG cases as the direct call
  feed     `main`'s recipe over 1024 synthetic cases under --device-feed
           host, resident and prefetch from the same seed: 8 steps each with
           bit-identical batches and losses, K1 4 launches a step (band),
           step times and the device's busy share, the upload's ms under
           `host`, the bytes the resident feed pins, what `auto` picks; one
           save_async of the stage-1 state against a synchronous save;
           streaming and the libjpeg loader where a JPEG encoder is there
  prefetch tools/bench_prefetch_torch.py at the JAX tool's defaults (160
           cases written as a fake Derm7pt tree, batch 32, 4 epochs of 3
           steps, resnet50, bf16) in a process of its own: the four feeds'
           images/s (sync, prefetch, resident, stream), each above 0, and
           each feed's launches (K1 4, K2f and K2b 1 a step, no other)
  vit      the same trainer with a ViT-B/16 encoder pair (vit_b16, v32, proj
           128, T 0.1, batch 64, --world-size 2, bf16 autocast, 224x224,
           --use-checkpoint flash): attention through K3 forward and
           backward, 48 launches of each a step, every one the tensor-core
           kernel; losses, launch counts, step time, images/s, peak memory
  crop_vit `crop`'s recipe on `vit`'s model (vit_b16, batch 64, flash,
           bf16): 3 steps through fit, K1 4 and K2 1 a step, K3 192 a step
           (12 blocks x (4 global + 12 local passes)), 48 at S = 197 and
           144 at S = 37, every one the tensor-core kernel; then K3 at the
           step's two (B, S, H, D) in bf16 against its plain versions (the
           times at both shapes are `kernels`')
  tri      --arch-version trimodal on vit_b16, batch 64, --use-checkpoint
           flash, the metadata vocabularies from the synthetic data's codes:
           3 steps through fit with `vit`'s launch counts (9 NT-Xent terms x
           2 groups in one K2 call), the same lines as `crop`, and its
           ckp_0.pth loaded strictly into a new TriModalSimCLR
  dist     [main]'s recipe under torch.distributed, cuDNN deterministic:
           leg A, a world-size-1 NCCL group through the port's
           distributed_initialize, SSLTrainer.fit over 3 steps under DDP
           with the global-batch BatchNorm, in bf16 against one process on
           the same BatchNorm kernels (losses within 1e-3 relative) and in
           float32 against the plain trainer (within 1e-4), parameters
           within Adam's step bound (6.34 x lr a step plus rounding);
           launches K1 4, K2f 1, K2b 1 a step; the bf16 step time against
           the plain trainer's (one process, so a CUDA graph; its eager
           step too, in turns), the device's busy time, the
           all-reduce bytes a step and one BatchNorm against one process's;
           leg B, two
           processes on the one card over gloo with CUDA tensors, one
           float32 step each at 48 rows against the one-process step, both
           ranks' states identical, the global-batch BatchNorm against
           F.batch_norm; leg D, two processes on the one card
           over gloo, bf16: `crop`'s recipe (resnet50, global batch 96) and
           `tri`'s (vit_b16 flash, global batch 64), 2 steps each through
           fit against the one-process run (losses within 1.5e-2, Adam's
           bound), both ranks' states identical, the launches, step times
           and peak memory of each rank; leg C, two NCCL ranks where two
           cards are there
  tp       tensor parallelism (--mesh-model 2): one-process runs of vit_b16
           stage 1 (v32, proj 128, global batch 32, 224x224, flash; 2 bf16
           steps and 1 float32 step through fit) and of one stage-2 step
           (resnet50 frozen, v4 / 512, batch 64, fixed targets); K3 at a
           rank's (32, 197, 6, 64) in bf16 against its plain version with
           its times, bound and the library's; then two processes on this
           card over gloo, a grid of data 1 x model 2, running the same:
           the kernel counts of the bf16 fit (K1 4, K2f 1, K2b 1, K3 48
           a step), a rank's slice of the q weight and its moments, the
           losses within [dist]'s limits, replicated weights identical on
           both ranks, rank 0's whole ckp_0.pth of each run loaded
           strictly by a one-process model within Adam's bound of the
           one-process weights; NCCL across cards where there are two
  learn    tools/demo_synthetic_e2e_torch.py at its defaults with
           --full-pipeline (resnet18 at 96 x 96, batch 48, 20 SSL epochs,
           40 stage-2 and 25 eval epochs on label-correlated textures):
           the random-init, SSL-probe and stage-2 eval AUC_AVG, the first
           and last SSL epoch loss, each stage's seconds, the launches (K1
           band only, K2f / K2b one a SSL step); every AUC and loss finite,
           the last SSL loss below the first, K1 816 launches, K2f / K2b
           60 each; then K1 at (48, 96, 96, 3) and K2 at (4, 96, 64)
           against their plain versions, under `path_shapes`
  copy     tools/bench_copy_torch.py (K4 against `x + 1`, GB/s)
  vmoe     K5, V-MoE's dispatch / combine and their backwards
           (sm3x_torch/csrc/moe_dispatch.cu), against the plain twins at one
           routing group of the benchmark's V-MoE-B/16 cell (N 12,608
           tokens, 32 experts of 827 slots, k 2, D 768) in bf16 and float32,
           twice for identical bits, each kernel's row with its times and
           its share of the bytes bound (portbench/harness/kernels_moe.py)
  bn       K6, batch norm with the block's add and ReLU folded in
           (sm3x_torch/csrc/batchnorm.cu), at every batch norm of ResNet-50
           at batch 96 and 224, forward and backward, against float64
           and its plain twin in bf16 and float32; in bf16 its times, the twin's, the
           one-library-call yardstick's (F.batch_norm, add, relu) and its
           share of the bytes bound, and a step's K6 time from them; the
           dispatch's counters as [main]'s step is captured as a CUDA
           graph (212 batch norms through K6, the projectors' 18 not)

With `--only main,dist` (any of kernels, step, main, feed, prefetch, dist,
vit, copy, vmoe, bn, crop, crop_vit, bnfreq, tri, transfer, tp, learn; serve: main,
stage2 and eval for the weights, then infer and serve; export: main,
stage2, eval, export) only those phases run after device and build, and no
result is printed.
Each phase prints the seconds it took.

With `--profile DIR`, the main, stage2, eval, probe, vit and dist phases
also write the device-time tables of three traced steps to
DIR/profile_step.txt, profile_stage2.txt, profile_eval.txt,
profile_probe.txt, profile_vit.txt and profile_dist_plain.txt /
profile_dist_dist.txt.

The last lines are a JSON object of the kernels, the card's name and power
limit as nvidia-smi prints them, and {"ok": true, "device": {...}}. Any
failed phase raises and the script exits non-zero without that last line.
The script imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
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
# the supervised stages at run.sh's recipes: batch 128, 8 train steps
EVAL_BATCH, EVAL_TRAIN_CASES, EVAL_TEST_CASES = 128, 1024, 256
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

    results["photometric"]["supervised"] = k1_supervised()

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
    for name, rows in kernels_at_path_shapes().items():
        results[name]["path_shapes"] = rows
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


def k1_supervised() -> dict:
    """K1 in the supervised stages' regime: (128, 224, 224, 3) with the
    parameter rows `build_params` draws from the finetune preset, where
    jitter, grayscale and blur are gated off on every image and only flip
    and normalise apply. Against the plain version, band kernel, twice for
    identical bits; its times beside a bound of one read and one write."""
    from sm3x_torch.ops import augment as A
    from sm3x_torch.ops import augment_cuda as K

    shape = (EVAL_BATCH, 224, 224, 3)
    images = torch.from_numpy(np.random.default_rng(7).random(
        shape, dtype=np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = K.build_params(gen, shape[0], A.FINETUNE_AUG, "cuda")
    gated = params[:, [K.P_DO_JIT, K.P_DO_GRAY, K.P_DO_BLUR]]
    flips = params[:, K.P_DO_FLIP]
    if bool(gated.any()) or not (0 < float(flips.sum()) < shape[0]):
        raise AssertionError("the finetune preset must gate off all but the "
                             "flip, and flip some images")
    before = dict(K.photometric_cuda.variants)
    got = K.photometric_cuda(images, params, MEAN, STD)
    again = K.photometric_cuda(images, params, MEAN, STD)
    want = K.photometric_plain(images, params, MEAN, STD)
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in K.photometric_cuda.variants.items()}
    log(f"[kernels] K1 photometric {shape}, finetune preset (flip on "
        f"{int(flips.sum())} of {shape[0]} images, every other step gated "
        f"off): kernels taken {took}")
    if took != {"band": 2, "scratch": 0}:
        raise AssertionError(f"K1 at {shape} took {took}, expected band")
    err = check_close("K1 out (supervised)", got, want, **K1_TOL)
    if not torch.equal(got, again):
        raise AssertionError("K1 does not repeat bit for bit")
    del want, again
    k1 = lambda: K.photometric_cuda(images, params, MEAN, STD)
    # a subtraction and a division a value: 6 operations a pixel
    row = dict(shape=list(shape), max_abs_err=err, ms=median_ms(k1),
               device_ms=device_ms(k1), kernel_ms=kernel_ms(k1),
               plain_ms=median_ms(lambda: K.photometric_plain(
                   images, params, MEAN, STD)),
               **bound(nbytes(images, params, got),
                       6 * images[..., 0].numel(), "f32"))
    alone = row["kernel_ms"] if row["kernel_ms"] is not None else row[
        "device_ms"]
    row["share_of_bound"] = row["bound_ms"] / alone
    log(f"  photometric (supervised): kernel {row['ms']:.4f} ms a single "
        f"launch, {row['device_ms']:.4f} ms device time, the kernel alone "
        f"{ms_or_not(row['kernel_ms'])}, bound {row['bound_us']:.1f} us "
        f"({row['bound_by']}, {100 * row['share_of_bound']:.1f}% of it "
        f"reached), plain {row['plain_ms']:.4f} ms")
    return row


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


# the shapes the multi-crop and tri-modal phases give the kernels: K1 over
# one modality's six 96 x 96 locals of a batch of 96; K2 over multi-crop's
# 16 terms and the tri-modal loss's 9 (batch 64), 2 groups each; K3 at a
# ViT-B/16 local view's 37 tokens (36 patches of 96 x 96 and the class
# token), which a ViT under multi-crop gives it
K1_LOCAL_SHAPE = (576, 96, 96, 3)
K2_PATH_SHAPES = {"crop": (32, 96, 128), "tri": (18, 64, 128)}
K3_LOCAL_SHAPE = (64, 37, 12, 64)


def timed(row, fn, plain, library=None):
    """`row` with the times of `fn` (a single launch, 50 in a row, the
    kernel alone), of its plain version and of the library call, and the
    share of the bound reached; one line of them."""
    row.update(ms=median_ms(fn), device_ms=device_ms(fn),
               kernel_ms=kernel_ms(fn), plain_ms=median_ms(plain),
               library_ms=None if library is None else device_ms(library))
    alone = row["kernel_ms"] if row["kernel_ms"] is not None else row[
        "device_ms"]
    row["share_of_bound"] = row["bound_ms"] / alone
    lib = (f", library {row['library_ms']:.4f} ms"
           if row["library_ms"] is not None else "")
    log(f"  {row['name']} {tuple(row['shape'])} {row['dtype']}: kernel "
        f"{row['ms']:.4f} ms a single launch, the kernel alone "
        f"{ms_or_not(row['kernel_ms'])}, bound {row['bound_us']:.1f} us "
        f"({row['bound_by']}, {100 * row['share_of_bound']:.1f}% of it "
        f"reached), plain {row['plain_ms']:.4f} ms{lib}")
    return row


def kernels_at_path_shapes() -> dict:
    """K1, K2f / K2b and K3 at the new paths' shapes against their plain
    versions at the [kernels] tolerances (K1 must take the band kernel),
    with the times and bounds of each: {kernel name: [rows]}."""
    out = {k: [] for k in ("photometric", "ntxent_fwd", "ntxent_bwd",
                           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    out["photometric"].append(k1_at_path_shape(
        K1_LOCAL_SHAPE, "crop", "kernels", "multi-crop's locals of one "
        "modality"))
    rng = np.random.default_rng(11)
    for path, shape in K2_PATH_SHAPES.items():
        for key, row in k2_at_path_shape(shape, path, "kernels", rng).items():
            out[key].append(row)
    for key, rows in k3_at_path_shape(
            K3_LOCAL_SHAPE, (torch.float32, torch.bfloat16), "crop (ViT)",
            "kernels", "a ViT-B/16 local view", rng).items():
        out[key] += rows
    return out


def k1_at_path_shape(shape, path: str, tag: str, what: str) -> dict:
    """K1 at `shape` against its plain version at the [kernels] tolerance,
    which must take the band kernel: the row of `path` with its times and
    bound, the lines under `[tag]`."""
    from sm3x_torch.ops import augment_cuda as K

    images, params = k1_inputs(shape[0], shape[1])
    plan = K.photometric_plan(*shape[1:3])
    before = dict(K.photometric_cuda.variants)
    got = K.photometric_cuda(images, params, MEAN, STD)
    took = {k: v - before[k] for k, v in K.photometric_cuda.variants.items()}
    log(f"[{tag}] K1 photometric {tuple(shape)} ({what}): {took}, "
        f"{plan['blocks']} blocks an image of {plan['band_rows']} rows, "
        f"{plan['px']} pixels a thread")
    if took != {"band": 1, "scratch": 0}:
        raise AssertionError(f"K1 at {tuple(shape)} took {took}")
    err = check_close(f"K1 out ({shape[1]} x {shape[2]})", got,
                      K.photometric_plain(images, params, MEAN, STD),
                      **K1_TOL)
    return timed(
        dict(name="photometric", path=path, shape=list(shape),
             dtype="float32", max_abs_err=err,
             **bound(nbytes(images, params, got),
                     130 * images[..., 0].numel(), "f32")),
        lambda: K.photometric_cuda(images, params, MEAN, STD),
        lambda: K.photometric_plain(images, params, MEAN, STD))


def k2_at_path_shape(shape, path: str, tag: str, rng) -> dict:
    """K2f and K2b at z of `shape` (problems, 2b, D) against their plain
    versions at the [kernels] tolerances: {"ntxent_fwd": row, "ntxent_bwd":
    row} of `path` with their times and bounds, the lines under `[tag]`."""
    from sm3x_torch.ops import ntxent_cuda as N

    z = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    g = torch.from_numpy(rng.random(shape[0], dtype=np.float32)).cuda()
    loss, lse, inv = N.ntxent_forward_cuda(z, 0.1)
    loss_p, lse_p, inv_p = N.ntxent_forward_plain(z, 0.1)
    dz = N.ntxent_backward_cuda(z, lse, inv, g, 0.1)
    dz_p = N.ntxent_backward_plain(z, lse_p, inv_p, g, 0.1)
    log(f"[{tag}] K2 ntxent z {tuple(shape)} ({path})")
    fwd_err = check_close("K2f loss", loss, loss_p, **K2F_TOL)
    check_close("K2f lse", lse, lse_p, **K2F_TOL)
    bwd_err = check_close("K2b dz", dz, dz_p, **K2B_TOL)
    s_flops = 2 * shape[0] * shape[1] ** 2 * shape[2]
    return {
        "ntxent_fwd": timed(
            dict(name="ntxent_fwd", path=path, shape=list(shape),
                 dtype="float32", max_abs_err=fwd_err,
                 **bound(nbytes(z, loss, lse, inv), s_flops, "f32")),
            lambda: N.ntxent_forward_cuda(z, 0.1),
            lambda: N.ntxent_forward_plain(z, 0.1)),
        "ntxent_bwd": timed(
            dict(name="ntxent_bwd", path=path, shape=list(shape),
                 dtype="float32", max_abs_err=bwd_err,
                 **bound(nbytes(z, lse, inv, g, dz), 2 * s_flops, "f32")),
            lambda: N.ntxent_backward_cuda(z, lse, inv, g, 0.1),
            lambda: N.ntxent_backward_plain(z, lse_p, inv_p, g, 0.1)),
    }


def k3_against_plain(shape, dtype, rng, tag: str, what: str) -> tuple:
    """K3f, K3b-dq and K3b-dkv at `shape` in `dtype` on seeded inputs
    against the plain forward and backward at the [kernels] tolerances, the
    lines under `[tag]`: ((q, k, v, do, out, lse, delta), {kernel name:
    error})."""
    from sm3x_torch.ops import attention as A3
    from sm3x_torch.ops import attention_cuda as K3

    scale = 1.0 / math.sqrt(shape[-1])
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).cuda().to(dtype)
        for _ in range(4))
    out_k, lse = K3.flash_forward_cuda(q, k, v, scale)
    dq, delta = K3.flash_backward_dq_cuda(q, k, v, out_k, do, lse, scale)
    dk, dv = K3.flash_backward_dkv_cuda(q, k, v, do, lse, delta, scale)
    f = [t.float() for t in (q, k, v, do)]
    out_p, lse_p = A3.attention_plain(*f[:3], scale)
    grads_p = A3.attention_backward_plain(*f[:3], out_p, f[3], lse_p, scale)
    name = str(dtype).replace("torch.", "")
    log(f"[{tag}] K3 flash attention {shape} {name} ({what})")
    errs = {}
    if dtype == torch.float32:
        errs["flash_fwd"] = check_close("K3f out", out_k, out_p, **K3F_TOL)
        check_close("K3f lse", lse, lse_p, **K3F_TOL)
        for key, got_g, want_g in zip(
                ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"),
                (dq, dk, dv), grads_p):
            errs[key] = max(errs.get(key, 0.0), check_close(
                f"K3b {key[10:]}", got_g, want_g, **K3B_TOL))
    else:
        e = float((out_k.float() - out_p).abs().max())
        rels = [float((got_g.float() - want_g).norm() / want_g.norm())
                for got_g, want_g in zip((dq, dk, dv), grads_p)]
        log(f"  K3f out (bf16): max abs err {e:.3e} against float32 "
            f"(bound {K3_BF16_FWD}); K3b dq / dk / dv relative Frobenius "
            f"err {[f'{r:.3e}' for r in rels]} (bound {K3_BF16_REL})")
        if not (e < K3_BF16_FWD and max(rels) < K3_BF16_REL):
            raise AssertionError(f"K3 in bf16 at {shape} disagrees")
        check_close("K3f lse (bf16) against float32", lse, lse_p,
                    **K3F_LSE_TOL)
        errs = {"flash_fwd": e, "flash_bwd_dq": rels[0],
                "flash_bwd_dkv": max(rels[1:])}
    return (q, k, v, do, out_k, lse, delta), errs


def k3_at_path_shape(shape, dtypes, path: str, tag: str, what: str,
                     rng) -> dict:
    """k3_against_plain at `shape` in each of `dtypes`, with the bound, the
    times and the library's attention of each: {kernel name: [rows]} of
    `path`."""
    import torch.nn.functional as F

    from sm3x_torch.ops import attention as A3
    from sm3x_torch.ops import attention_cuda as K3

    out = {k: [] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    b, s, h, d = shape
    scale = 1.0 / math.sqrt(d)
    qk_flops = 2 * b * h * s * s * d
    for dtype in dtypes:
        (q, k, v, do, out_k, lse, delta), errs = k3_against_plain(
            shape, dtype, rng, tag, what)
        name = str(dtype).replace("torch.", "")
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_in = [t.transpose(1, 2) for t in leaves]
        out_l = F.scaled_dot_product_attention(*lib_in, scale=scale)
        lib_det = [t.detach() for t in lib_in]
        stats = lse
        rows = (
            ("flash_fwd", lambda: K3.flash_forward_cuda(q, k, v, scale),
             lambda: A3.attention_plain(q, k, v, scale),
             lambda: F.scaled_dot_product_attention(*lib_det, scale=scale),
             bound(nbytes(q, k, v, out_k, stats), 2 * qk_flops,
                   "bf16" if dtype == torch.bfloat16 else "f32")),
            ("flash_bwd_dq",
             lambda: K3.flash_backward_dq_cuda(q, k, v, out_k, do, lse,
                                               scale),
             lambda: A3.attention_backward_plain(q, k, v, out_k, do, lse,
                                                 scale),
             lambda: torch.autograd.grad(out_l, leaves, do.transpose(1, 2),
                                         retain_graph=True),
             bound(nbytes(q, k, v, out_k, do, stats, stats, q), 3 * qk_flops,
                   "bf16" if dtype == torch.bfloat16 else "f32")),
            ("flash_bwd_dkv",
             lambda: K3.flash_backward_dkv_cuda(q, k, v, do, lse, delta,
                                                scale),
             lambda: A3.attention_backward_plain(q, k, v, out_k, do, lse,
                                                 scale),
             lambda: torch.autograd.grad(out_l, leaves, do.transpose(1, 2),
                                         retain_graph=True),
             bound(nbytes(q, k, v, do, stats, stats, k, v), 4 * qk_flops,
                   "bf16" if dtype == torch.bfloat16 else "f32")))
        for key, fn, plain, lib, bnd in rows:
            row = dict(name=key, path=path, shape=list(shape), dtype=name,
                       max_abs_err=errs[key], **bnd)
            out[key].append(timed(row, fn, plain, lib))
        del out_l, leaves, lib_in, lib_det
    return out


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


def step_against_cpu(tag: str, arch: str, size: int, make_views,
                     remat=False, local_weight: float = 1.0) -> None:
    """One float32 step of `arch` / v32 (projection 32) at `size` x `size`,
    batch 8, world size 2: the CUDA path (kernels) against the CPU path
    (plain versions) on the same weights and the same views, which
    `make_views(data)` makes on the card with K1: ((derm globals), (clinic
    globals), (derm locals), (clinic locals)). Loss parts within rtol 1e-4
    / atol 1e-5, parameters within 3 x lr."""
    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.models.simclr import build_ssl_model
    from sm3x_torch.train.backbone_train import ssl_update
    from sm3x_torch.train.common import make_adamw

    torch.manual_seed(0)
    cpu_model, style = build_ssl_model("v32", arch, 32, remat=remat,
                                       img_size=size)
    gpu_model, _ = build_ssl_model("v32", arch, 32, remat=remat,
                                   img_size=size)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.cuda()
    views = make_views(SyntheticPairedData(8, canvas=96, seed=4))
    out = {}
    for name, model, dev in (("cpu", cpu_model, "cpu"),
                             ("cuda", gpu_model, "cuda")):
        opt = make_adamw(model.parameters(), 1e-3, 5e-2, eps=1e-5)
        d, c, dl, cl = (tuple(v.to(dev) for v in group) for group in views)
        out[name] = ssl_update(model, opt, d, c, style, 0.1, 2,
                               derm_locals=dl, clinic_locals=cl,
                               local_weight=local_weight)
    log(f"[step] {tag}, one step, CUDA vs CPU")
    for k in out["cpu"]:
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


def phase_step() -> None:
    """resnet18 / v32 at 64x64 with two global views; then a ViT (vit_t16,
    --use-checkpoint flash, so attention is K3 in float32 on the card)
    under multi-crop: 32x32 globals and two 16x16 locals a modality, where
    the locals' pos_embed is the 2 x 2 grid shrunk to 1 x 1."""
    import dataclasses

    from sm3x_torch.ops.augment import (SSL_AUG, multicrop_augment_batch,
                                        ssl_augment_batch)

    def two_views(data):
        cfg = dataclasses.replace(SSL_AUG, out_size=(64, 64))
        views = []
        for k, (canv, hw) in enumerate(((data.derm, data.derm_hw),
                                        (data.clinic, data.clinic_hw)) * 2):
            gen = torch.Generator(device="cuda").manual_seed(10 + k)
            views.append(ssl_augment_batch(
                gen, torch.from_numpy(canv).cuda(),
                torch.from_numpy(hw).cuda(), MEAN, STD, cfg))
        return (views[0], views[2]), (views[1], views[3]), (), ()

    def crops(data):
        per = [multicrop_augment_batch(
            20 + k, torch.from_numpy(canv).cuda(),
            torch.from_numpy(hw).cuda(), MEAN, STD, size_crops=(32, 16),
            nmb_crops=(2, 2)) for k, (canv, hw) in enumerate(
                ((data.derm, data.derm_hw), (data.clinic, data.clinic_hw)))]
        return (tuple(per[0][:2]), tuple(per[1][:2]), tuple(per[0][2:]),
                tuple(per[1][2:]))

    step_against_cpu("resnet18/v32 64x64 b8 fp32", "resnet18", 64,
                     two_views)
    step_against_cpu("vit_t16/v32 flash, multi-crop 2 x 32x32 + 2 x 16x16 "
                     "a modality, b8 fp32", "vit_t16", 32, crops,
                     remat="flash")


def profile_steps(step, n: int, out_dir: str, name: str) -> dict:
    """torch.profiler over step(0) .. step(n - 1): device time by kernel,
    per step, and the device's busy share of the host-clock window; returns
    `profile_device`'s result."""
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
    return res


def kernel_counters():
    """(every kernel wrapper, `sm3x_torch.ops.counted_kernels`, the three K3
    wrappers), each with its `launches` count; K1 and K3 also count by
    kernel in `variants`."""
    from sm3x_torch.ops import counted_kernels

    counters = counted_kernels()
    return counters, tuple(fn for fn in counters if hasattr(fn, "shapes"))


# each wrapper's kernels by name in the device trace (K3's as the
# benchmark's attention reader matches them)
DEVICE_KERNELS = {
    "photometric_cuda": r"photometric_(?:band|scratch)_kernel\b",
    "ntxent_forward_cuda": r"ntxent_fwd_kernel\b",
    "ntxent_backward_cuda": r"ntxent_bwd_kernel\b",
    "flash_forward_cuda": r"(?:^|::|\s)(?:flash_)?fwd_kernel\b",
    "flash_backward_dq_cuda": r"(?:^|::|\s)(?:flash_)?bwd_dq_kernel\b",
    "flash_backward_dkv_cuda": r"(?:^|::|\s)(?:flash_)?bwd_dkv_kernel\b",
    "copy_cuda": r"(?:^|::|\s)copy_kernel\b",
    "moe_dispatch_cuda": r"moe_dispatch_fwd_kernel\b",
    "moe_combine_cuda": r"moe_combine_fwd_kernel\b",
    "moe_combine_backward_cuda": r"moe_combine_bwd_kernel\b",
    "moe_dispatch_backward_cuda": r"moe_dispatch_bwd_kernel\b",
    "bn_forward_cuda": r"(?:^|::)bn_fwd_\w+_kernel\b",
    "bn_backward_cuda": r"(?:^|::)bn_bwd_\w+_kernel\b",
}


def device_launch_check(res: dict, n: int, host: dict, per_step: dict,
                        tag: str) -> None:
    """Each wrapper's kernels a step in the device trace of `n` steps
    (`profile_device`'s result) against its host count over the same steps
    (`host`, by wrapper) and `per_step`: a replayed graph's launches are
    counted on the host from its capture, so only the trace can show a
    kernel that a replay leaves out."""
    seen = {name: sum(e.count for e in res["rows"] if re.search(rx, e.key))
            for name, rx in DEVICE_KERNELS.items()}
    log(f"  kernels a step in the device trace of {n} steps: "
        f"{ {k: v / n for k, v in seen.items()} }; on the host: "
        f"{ {k: v / n for k, v in host.items()} }")
    want = {k: per_step.get(k, 0) * n for k in DEVICE_KERNELS}
    if seen != want or host != want:
        raise AssertionError(f"[{tag}] kernels in the trace {seen}, on the "
                             f"host {host}, expected {want}")


def reset_counters() -> None:
    counters, k3 = kernel_counters()
    for fn in counters:
        fn.launches = 0
    for fn in k3 + counters[:1]:
        fn.variants = dict.fromkeys(fn.variants, 0)
    for fn in k3:
        fn.shapes = {}


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


def stage1_cfg(tag: str, arch: str, batch: int, use_checkpoint=False):
    """Stage 1 at the run.sh recipe with encoder `arch`, logging under
    LOGS/tag (emptied)."""
    from sm3x_torch.core.config import SSLConfig

    cfg = SSLConfig()
    m, o, r = cfg.model, cfg.optim, cfg.run
    m.arch, m.arch_version, m.proj_dim, m.temperature = (arch, "v32", 128,
                                                         0.1)
    m.use_checkpoint = use_checkpoint
    o.batch_size, o.base_lr, o.adam_eps, o.amp, o.epochs = (batch, 1e-6, 1e-5,
                                                            True, 1)
    cfg.data.img_sz, cfg.data.mean, cfg.data.std = (224, 224), MEAN, STD
    r.world_size, r.device, r.print_freq = 2, "cuda", 10 ** 6
    if tag != "main":
        # ckp_0.pth alone; [main] writes checkpoint.pth too. A call's
        # machine takes 45 GiB of writes to its disk, deleted files
        # included, and two ViT-B/16 with their moments are 2 GiB a file
        r.ckpt_freq = 100
    r.log_path = os.path.join(LOGS, tag)
    shutil.rmtree(r.log_path, ignore_errors=True)
    return cfg


def phase_fit(tag: str, arch: str, batch: int, steps: int, use_checkpoint,
              per_step: dict, profile_dir=None, profile_name=None,
              tweak=None, busy: bool = False, then=None,
              traced: bool = False) -> tuple:
    """The stage-1 trainer at the run.sh recipe with encoder `arch`: `steps`
    steps through SSLTrainer.fit with every kernel count set to 0 just
    before and read just after (each must equal `per_step` x steps), then
    the step time over two more epochs and the loss's parts of the last of
    them. `tweak(cfg, data)` changes the recipe (the multi-crop and
    tri-modal phases); with `busy` the device's busy time of three traced
    steps is printed too, and with `traced` each kernel's launches in that
    trace are held against the host's counts (`device_launch_check`); the
    trainer logs whether its step is a CUDA graph or eager (and why), and
    so does this phase; `then(trainer, batches)` runs last, with four
    batches of a later epoch on the card (the [bnfreq] checks). Returns
    the launches in fit by wrapper and each K3 wrapper's by (B, S, H,
    D)."""
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.train.backbone_train import SSLTrainer

    cfg = stage1_cfg(tag, arch, batch, use_checkpoint)
    r = cfg.run
    # a PairedImageData: under --device-feed auto, fit takes the resident
    # feed for it
    data = synthetic_paired_data(batch * steps, canvas=320, seed=0)
    if tweak is not None:
        tweak(cfg, data)
    trainer = SSLTrainer(cfg)
    log(f"[{tag}] stage-1 update: " + (
        "eager (" + "; ".join(trainer.graph_refusals) + ")"
        if trainer.graph_refusals else "one CUDA graph from the second step"))
    counters, k3 = kernel_counters()
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = trainer.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    variants = {fn.__name__: dict(fn.variants) for fn in k3}
    shapes = {fn.__name__: dict(fn.shapes) for fn in k3}
    k1_variants = dict(K.photometric_cuda.variants)
    peak = torch.cuda.max_memory_allocated()
    losses = hist[0]["step_losses"]
    log(f"[{tag}] stage-1 step: {arch}/{cfg.model.arch_version}, proj 128, "
        f"T 0.1, batch {batch}, world size 2, bf16 autocast, 224x224, "
        f"--data-name {cfg.data.data_name}, --use-checkpoint "
        f"{trainer.remat}; {steps} steps via SSLTrainer.fit in {wall:.2f} s")
    log(f"  losses per step: {losses}")
    log(f"  kernel launches in fit: {launches}")
    log(f"  K1 launches by kernel (band: one read and one write of each "
        f"image; scratch: the general-shape path): {k1_variants}")
    log(f"  K3 launches by kernel (fma float32, mma bf16): {variants}")
    if launches["flash_forward_cuda"]:
        log(f"  K3 launches by (B, S, H, D): {shapes}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected {steps} finite losses, got {losses}")
    want = {fn.__name__: per_step.get(fn.__name__, 0) * steps
            for fn in counters}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    # every K1 launch of stage 1 (224 x 224, 96 x 96) is the band kernel
    if k1_variants != {"band": launches["photometric_cuda"], "scratch": 0}:
        raise AssertionError(f"K1 kernels {k1_variants}, expected band only")
    # bf16 autocast: every K3 launch is a tensor-core kernel
    if any(v != {"fma": 0, "mma": launches[n]} for n, v in variants.items()):
        raise AssertionError(f"K3 kernels {variants}, expected mma only")
    written = sorted(f for f in os.listdir(r.log_path) if f.endswith(".pth"))
    # [main] writes checkpoint.pth too, from ckp_0.pth's snapshot
    want_files = ["ckp_0.pth"] + (["checkpoint.pth"] if r.ckpt_freq == 1
                                  else [])
    if written != sorted(want_files):
        raise AssertionError(f"fit wrote {written}, expected {want_files}")
    if r.ckpt_freq == 1:
        a, b = (torch.load(os.path.join(r.log_path, f), weights_only=True,
                           mmap=True) for f in want_files)
        if a["epoch"] != b["epoch"] or not all(
                torch.equal(a["state_dict"][k], v)
                for k, v in b["state_dict"].items()):
            raise AssertionError("checkpoint.pth differs from ckp_0.pth")
        log("  fit wrote ckp_0.pth and checkpoint.pth from one snapshot: "
            "the same epoch and weights")

    def device_batches(epoch):
        # the tri-modal step's metadata codes stay on the host
        return [([torch.from_numpy(x).cuda() for x in
                  (b.derm, b.derm_hw, b.clinic, b.clinic_hw)],
                 trainer._meta(b))
                for b in data.batches(batch, epoch, cfg.run.seed)]

    metrics = []

    def step(args, it):
        metrics.append(trainer.train_step(*args[0], it, *args[1]))
        return metrics[-1]["loss"]

    # step time: two more epochs of the same trainer, each step ended by a
    # sync
    times = timed_steps([
        lambda it=it, args=args: step(args, it)
        for it, args in enumerate(device_batches(1) + device_batches(2))])
    step_s = statistics.median(times)
    log(f"  step time: median {step_s * 1e3:.1f} ms over {len(times)} steps, "
        f"min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f} (host "
        f"clock, synchronised; canvases uploaded before the clock); "
        f"{4 * batch / step_s:.1f} images/s (4 x batch per step)")
    parts = {k: float(v) for k, v in metrics[-1].items()}
    log(f"  the loss's parts at the last step: {parts}")
    if not all(math.isfinite(v) for v in parts.values()):
        raise AssertionError(f"non-finite loss parts {parts}")
    log(f"  peak device memory in fit: {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    if profile_dir or busy or traced:
        batches = device_batches(3)[:3]
        run = lambda it: trainer.train_step(*batches[it][0], it,
                                            *batches[it][1])
        if traced:
            reset_counters()
        if profile_dir:
            res = profile_steps(run, len(batches), profile_dir, profile_name)
        else:
            res = profile_device(run, len(batches))
            log(f"  device busy {res['busy_ms']:.1f} ms a step of "
                f"{res['wall_ms']:.1f} ms on the host clock under the "
                f"profiler ({100 * res['busy_ms'] / res['wall_ms']:.1f}% "
                f"busy), {res['launches']:.0f} kernels and copies a step")
        if traced:
            device_launch_check(res, len(batches),
                                {fn.__name__: fn.launches for fn in counters},
                                per_step, tag)
    if then is not None:
        then(trainer, device_batches(3)[:4])
    return launches, shapes


# kernel launches a step on each path, by wrapper
SSL_PER_STEP = {"photometric_cuda": 4, "ntxent_forward_cuda": 1,
                "ntxent_backward_cuda": 1}


def r50_k6(calls: int, backward: bool = True) -> dict:
    """K6's launches for `calls` ResNet-50 encoder calls in train mode on
    one process: 53 batch norms a call, two kernels forward and two
    backward each (none under a process group, whose batch norm is the
    global batch's)."""
    return {"bn_forward_cuda": 2 * 53 * calls,
            "bn_backward_cuda": 2 * 53 * calls if backward else 0}


MAIN_PER_STEP = dict(SSL_PER_STEP, **r50_k6(4))
VIT_PER_STEP = dict(SSL_PER_STEP, flash_forward_cuda=48,
                    flash_backward_dq_cuda=48, flash_backward_dkv_cuda=48)


def phase_main(profile_dir=None) -> dict:
    return phase_fit("main", "resnet50", MAIN_BATCH, MAIN_STEPS, False,
                     MAIN_PER_STEP, profile_dir, "profile_step.txt",
                     traced=True)[0]


def phase_vit(profile_dir=None) -> dict:
    """vit_b16 with --use-checkpoint flash: 12 blocks x 4 encoder passes
    give 48 launches of each K3 kernel a step."""
    return phase_fit("vit", "vit_b16", VIT_BATCH, VIT_STEPS, "flash",
                     VIT_PER_STEP, profile_dir, "profile_vit.txt",
                     traced=True)[0]


# multi-crop at the CLI defaults: globals 224 (scales 0.5-1), six locals of
# 96 (0.14-0.5) a modality; each crop group of a modality is one K1 launch
CROP_STEPS = 3
CROP_PER_STEP = dict(SSL_PER_STEP, **r50_k6(16))   # 4 global + 12 local passes
TRI_STEPS, TRI_BATCH = 3, 64


def crop_tweak(cfg, data) -> None:
    """--data-name SevenPCSwavDataset at the CLI's multi-crop defaults: 2 x
    224 and 6 x 96 views a modality, local weight 1.0."""
    d = cfg.data
    d.data_name = "SevenPCSwavDataset"
    d.size_crops, d.nmb_crops = (224, 96), (2, 6)
    d.min_scale_crops, d.max_scale_crops = (0.5, 0.14), (1.0, 0.5)
    cfg.model.local_loss_weight = 1.0


def tri_tweak(cfg, data) -> None:
    """--arch-version trimodal, the metadata vocabularies from the
    synthetic Derm7pt's codes."""
    cfg.model.arch_version = "trimodal"
    cfg.model.meta_vocab_sizes = tuple(data.meta_vocab_sizes)


def phase_crop() -> dict:
    """run.sh's stage 1 under the multi-crop recipe (crop_tweak); 16
    NT-Xent terms in 2 groups, one K2 call a step."""
    return phase_fit("crop", "resnet50", MAIN_BATCH, CROP_STEPS, False,
                     CROP_PER_STEP, tweak=crop_tweak, busy=True)[0]


# --bn-stat-freq 4 on [main]'s recipe: fit's steps 0 and 4 refresh the
# statistics, the other six take the fast step; the same kernels either way
BNFREQ_K, BNFREQ_STEPS = 4, 8


def bnfreq_tweak(cfg, data) -> None:
    cfg.model.bn_stat_freq = BNFREQ_K


def bnfreq_checks(trainer, batches) -> None:
    """The fast step leaves every running statistic as it was, bit for bit,
    and the model in train mode; the standard step moves them; then each
    step's device busy ms, launches and top kernels over three traced
    steps, and the host-clock ms of six steps of each in turns."""
    bns = [m for m in trainer.model.modules()
           if hasattr(m, "running_mean")]
    stats = lambda: [t.clone() for m in bns for t in (
        m.running_mean, m.running_var, m.num_batches_tracked)]
    params = lambda: [p.detach().clone() for p in trainer.model.parameters()]
    (args, meta), seed = batches[0], 10 ** 6
    before, weights = stats(), params()
    trainer.fast_step(*args, seed, *meta)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(before, stats())):
        raise AssertionError("the fast step moved a running statistic")
    if not all(m.training for m in trainer.model.modules()):
        raise AssertionError("the fast step left a module in eval mode")
    moved = sum(not torch.equal(a, b) for a, b in zip(weights, params()))
    if moved == 0:
        raise AssertionError("the fast step moved no parameter")
    before = stats()
    trainer.train_step(*args, seed + 1, *meta)
    torch.cuda.synchronize()
    after = stats()
    means = [not torch.equal(before[i], after[i])
             for i in range(0, len(after), 3)]
    counts = [int(after[i] - before[i]) for i in range(2, len(after), 3)]
    if not all(means) or min(counts) < 1:
        raise AssertionError(f"the standard step moved {sum(means)} of "
                             f"{len(means)} running means, counts {counts}")
    log(f"  fast step: {len(bns)} BatchNorms' running statistics identical "
        f"bit for bit, {moved} of {len(weights)} parameter tensors moved, "
        f"every module back in train mode; standard step: every running "
        f"mean moved, every count up (by {sorted(set(counts))}: one a "
        f"forward pass through the layer)")
    steps = {"standard": trainer.train_step, "fast": trainer.fast_step}
    for name, fn in steps.items():
        res = profile_device(lambda it, fn=fn: fn(*batches[it][0], it,
                                                  *batches[it][1]), 3)
        log(f"  {name} step: device busy {res['busy_ms']:.1f} ms a step of "
            f"{res['wall_ms']:.1f} ms on the host clock under the profiler, "
            f"{res['launches']:.0f} kernels and copies a step; its three "
            f"longest kernels:")
        for e in res["rows"][:3]:
            log(f"    {getattr(e, res['field']) / 3e3:8.3f} ms/step "
                f"x{e.count // 3:<4d} {e.key[:150]}")
    order = [name for _ in range(6) for name in ("standard", "fast")]
    times = timed_steps([
        lambda it=it, fn=steps[name]: fn(*batches[it % 4][0], it,
                                         *batches[it % 4][1])["loss"]
        for it, name in enumerate(order)])
    for name in steps:
        own = [t * 1e3 for t, n in zip(times, order) if n == name]
        log(f"  {name} step in turns: median {statistics.median(own):.1f} "
            f"ms, min {min(own):.1f} over {len(own)} steps (host clock, "
            f"synchronised)")


# K6 runs in the standard steps alone (the fast step's batch norms are in
# eval mode): 2 of the 8, spread over the 8 for fit's count
BNFREQ_PER_STEP = dict(SSL_PER_STEP, **{
    k: v * (BNFREQ_STEPS // BNFREQ_K) // BNFREQ_STEPS
    for k, v in r50_k6(4).items()})


def phase_bnfreq() -> dict:
    """[main]'s recipe under --bn-stat-freq 4 (EXPERIMENTAL, off-recipe):
    8 steps through fit with K1 4, K2f 1 and K2b 1 launches a step (all
    band) and K6 in the 2 standard steps, then bnfreq_checks."""
    return phase_fit("bnfreq", "resnet50", MAIN_BATCH, BNFREQ_STEPS, False,
                     BNFREQ_PER_STEP, tweak=bnfreq_tweak,
                     then=bnfreq_checks)[0]


# [crop]'s recipe on [vit]'s model: each view is its own encoder pass (the
# two globals of a modality, then its six locals one by one), so K3 runs 12
# blocks x (4 global + 12 local passes) a step, at S = 197 (224 / 16 = 14
# patches a side, and the class token) and S = 37 (96 / 16 = 6: the locals'
# pos_embed is the 14 x 14 grid shrunk to 6 x 6); K1 and K2 as in [crop]
VIT_CROP_STEPS = 3
VIT_CROP_PASSES = {197: 4, 37: 12}
VIT_CROP_PER_STEP = dict(
    SSL_PER_STEP, **{name: 12 * sum(VIT_CROP_PASSES.values()) for name in
                      ("flash_forward_cuda", "flash_backward_dq_cuda",
                       "flash_backward_dkv_cuda")})


def phase_crop_vit() -> tuple:
    """[crop]'s recipe on vit_b16 with --use-checkpoint flash, batch 64, 3
    steps through fit: the launch counts, K3's launches at each S, then K3
    at the step's (B, S, H, D) in bf16 against its plain versions (timed
    at both shapes in [kernels]): (the launches, {kernel name: [rows]})."""
    launches, shapes = phase_fit("crop_vit", "vit_b16", VIT_BATCH,
                                 VIT_CROP_STEPS, "flash", VIT_CROP_PER_STEP,
                                 tweak=crop_tweak, busy=True)
    for name, by_shape in shapes.items():
        want = {(VIT_BATCH, s, 12, 64): 12 * n * VIT_CROP_STEPS
                for s, n in VIT_CROP_PASSES.items()}
        log(f"  {name}: {by_shape.get(VIT_SHAPE, 0)} launches at S = 197, "
            f"{by_shape.get(K3_LOCAL_SHAPE, 0)} at S = 37")
        if by_shape != want:
            raise AssertionError(f"{name} by shape {by_shape}, expected "
                                 f"{want}")
    rows = {}
    rng = np.random.default_rng(13)
    for shape in sorted(shapes["flash_forward_cuda"]):
        _, errs = k3_against_plain(shape, torch.bfloat16, rng, "crop_vit",
                                   f"the step's S = {shape[1]}")
        for key, err in errs.items():
            rows.setdefault(key, []).append(dict(
                name=key, path="crop_vit", shape=list(shape),
                dtype="bfloat16", max_abs_err=err))
    return launches, rows


def phase_tri() -> dict:
    """--arch-version trimodal on vit_b16, batch 64, --use-checkpoint flash,
    the metadata vocabularies from the synthetic Derm7pt's codes; then its
    ckp_0.pth loads strictly into a new TriModalSimCLR."""
    from sm3x_torch.models.trimodal import TriModalSimCLR

    sizes = []

    def tweak(cfg, data):
        tri_tweak(cfg, data)
        sizes.append(cfg.model.meta_vocab_sizes)

    launches = phase_fit("tri", "vit_b16", TRI_BATCH, TRI_STEPS, "flash",
                         VIT_PER_STEP, tweak=tweak, busy=True)[0]
    ckpt = torch.load(os.path.join(LOGS, "tri", "ckp_0.pth"),
                      weights_only=True)
    model = TriModalSimCLR("vit_b16", 128, sizes[0], remat="flash",
                           img_size=224)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    log(f"  metadata vocabularies {sizes[0]}; ckp_0.pth loads strictly into "
        f"a new TriModalSimCLR ({len(ckpt['state_dict'])} tensors)")
    return launches


TRANSFER_TRAIN, TRANSFER_TEST, TRANSFER_BATCH, TRANSFER_EPOCHS = 256, 64, 64, 2


def write_isic17(root: str, seed: int = 0) -> None:
    """A synthetic ISIC 2017 tree: JPEGs of 100-370 pixels a side in the
    challenge's folders, label CSVs with its two binary columns."""
    import csv

    rng = np.random.default_rng(seed)
    for sub, name, n in (("ISIC-2017_Training_Data", "train_labels.csv",
                          TRANSFER_TRAIN),
                         ("ISIC-2017_Test_v2_Data", "test_labels.csv",
                          TRANSFER_TEST)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, name), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["image_id", "melanoma", "seborrheic_keratosis"])
            for i, img in enumerate(raw_images(n, int(rng.integers(1 << 30)))):
                with open(os.path.join(root, sub, f"ISIC_{i:07d}.jpg"),
                          "wb") as out:
                    out.write(encode_image(img, "JPEG", image_decoder()))
                w.writerow([f"ISIC_{i:07d}", int(rng.integers(2)),
                            int(rng.integers(2))])


def phase_transfer() -> dict:
    """The ISIC transfer probe (tools/transfer_probe_torch.py's function)
    on a synthetic ISIC17 tree, from [main]'s ckp_0.pth (a fresh stage-1
    model's from the seed where [main] did not run): the resnet50 derm
    encoder frozen under 2 binary heads, batch 64, 2 epochs, bf16 autocast;
    K1 once a train batch, all `band`."""
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.train.transfer_probe import run_transfer_probe

    ckpt = os.path.join(LOGS, "main", "ckp_0.pth")
    source = "[main]'s ckp_0.pth"
    if not os.path.exists(ckpt):
        from sm3x_torch.models.simclr import build_ssl_model

        torch.manual_seed(3407)
        model, _ = build_ssl_model("v32", "resnet50", 128)
        ckpt = os.path.join(LOGS, "transfer", "ckp_0.pth")
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        torch.save({"epoch": 1, "state_dict": model.state_dict()}, ckpt)
        source = "a stage-1 model from seed 3407 ([main] did not run)"
    root = os.path.join(LOGS, "transfer", "ISIC2017")
    t0 = time.perf_counter()
    write_isic17(root)
    log(f"[transfer] ISIC17 probe from {source}: {TRANSFER_TRAIN} train / "
        f"{TRANSFER_TEST} test JPEGs of 100-370 pixels a side written in "
        f"{time.perf_counter() - t0:.1f} s")
    import logging

    logger, _ = capture_logger("chip_smoke.transfer")
    stamps = []
    stamp = logging.Handler()
    stamp.emit = lambda r: stamps.append((r.created, r.getMessage()))
    logger.addHandler(stamp)
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    best = run_transfer_probe(
        ckpt, "ISIC17Dataset", root, arch="resnet50", modality="derm",
        img_sz=(224, 224), batch_size=TRANSFER_BATCH, epochs=TRANSFER_EPOCHS,
        cache_size=320, workers=8, logger=logger, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counters, _ = kernel_counters()
    launches = {fn.__name__: fn.launches for fn in counters}
    marks = [t for t, msg in stamps if msg.startswith(("transfer probe: ",
                                                       "probe epoch "))]
    epoch_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    log(f"  {wall:.2f} s in all (decode included); ms an epoch "
        f"{[round(t, 1) for t in epoch_ms]} (train views, 4 steps, and the "
        f"eval pass; the first epoch's cuDNN autotune included)")
    log(f"  kernel launches: {launches}; K1 by kernel "
        f"{dict(K.photometric_cuda.variants)}")
    log(f"  best val: AUC_AVG {best['AUC_AVG']:.4f}, AUC_L0 "
        f"{best['AUC_L0']:.4f}, AUC_L1 {best['AUC_L1']:.4f}, loss "
        f"{best['loss']:.4f}; peak device memory {peak / 2 ** 30:.2f} GiB")
    steps = TRANSFER_EPOCHS * (TRANSFER_TRAIN // TRANSFER_BATCH)
    want = dict.fromkeys(launches, 0)
    want["photometric_cuda"] = steps
    if launches != want or K.photometric_cuda.variants != {
            "band": steps, "scratch": 0}:
        raise AssertionError(f"launches {launches}, expected {want}, band")
    if len(epoch_ms) != TRANSFER_EPOCHS or not all(
            math.isfinite(v) for v in best.values()) or not (
            0.0 <= best["AUC_AVG"] <= 1.0):
        raise AssertionError(f"transfer probe: {best}, epochs {epoch_ms}")
    return launches


# the learning demo at its defaults: 20 SSL epochs, the full pipeline (40
# stage-2 and 25 eval epochs); K1 and K2 at its shapes: a view of a
# modality at batch 48, 96 x 96; four NT-Xent terms (v32, one group) of
# 2 x 48 rows of the 64-wide projection
LEARN_ARGV = ["--device", "cuda", "--full-pipeline"]
LEARN_K1_SHAPE = (48, 96, 96, 3)
LEARN_K2_SHAPE = (4, 96, 64)
# 134 train cases at batch 48: 3 steps an epoch; K1 twice a step in the
# probes' train passes (15 epochs each), four times a SSL step, twice a
# batch in stage 2's init pass and steps (40 epochs) and in the eval's
# train steps (25 epochs)
LEARN_SSL_STEPS = 20 * 3
LEARN_K1 = 2 * (2 * 15 * 3) + 4 * LEARN_SSL_STEPS + 2 * 3 * 41 + 2 * 25 * 3


def phase_learn() -> tuple:
    """tools/demo_synthetic_e2e_torch.py's main at its defaults on the card,
    its output in LOGS/learn/demo.log, with every kernel count set to 0 just
    before and read just after: the three AUCs, the SSL epoch losses, each
    stage's seconds, the launches. Then K1 and K2 at the demo's shapes
    against their plain versions. Returns (launches, {kernel: [rows]})."""
    import importlib.util

    from sm3x_torch.ops import augment_cuda as K

    log_path = os.path.join(LOGS, "learn")
    shutil.rmtree(log_path, ignore_errors=True)
    os.makedirs(log_path)
    spec = importlib.util.spec_from_file_location(
        "demo_synthetic_e2e_torch",
        os.path.join(ROOT, "tools", "demo_synthetic_e2e_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    out_file = os.path.join(log_path, "demo.log")
    reset_counters()
    t0 = time.perf_counter()
    with open(out_file, "w") as f, contextlib.redirect_stdout(f):
        res = demo.main(LEARN_ARGV + ["--log-path", log_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counters, _ = kernel_counters()
    launches = {fn.__name__: fn.launches for fn in counters}
    variants = dict(K.photometric_cuda.variants)
    with open(out_file) as f:
        said = [ln.rstrip() for ln in f if ln.startswith((
            "data:", "random-init probe:", "SSL ", "SSL-pretrained probe:",
            "RESULT:", "MLC ", "FULL-PIPELINE RESULT:"))]
    log(f"[learn] tools/demo_synthetic_e2e_torch.py {' '.join(LEARN_ARGV)} "
        f"(resnet18 at 96, batch 48, 20 SSL epochs, 40 stage-2 and 25 eval "
        f"epochs) in {wall:.1f} s; the demo's lines:")
    for ln in said:
        log(f"  {ln}")
    losses = res["ssl_losses"]
    sec = res["seconds"]
    log(f"  AUC_AVG: random-init probe {res['auc_random']:.4f}, SSL probe "
        f"{res['auc_ssl']:.4f}, stage-2 eval {res['auc_eval']:.4f} (random "
        f"< SSL {res['auc_random'] < res['auc_ssl']}, SSL < stage 2 "
        f"{res['auc_ssl'] < res['auc_eval']}; not gated)")
    log(f"  SSL epoch loss: first {losses[0]:.4f}, last {losses[-1]:.4f} "
        f"({len(losses)} epochs)")
    log(f"  seconds: random-init probe {sec['random-init probe']:.1f}, SSL "
        f"fit {sec['ssl']:.1f}, SSL probe {sec['SSL-pretrained probe']:.1f}, "
        f"stage 2 {sec['mlc']:.1f}, eval {sec['eval']:.1f}")
    log(f"  kernel launches: {launches}; K1 by kernel {variants}")
    values = [res["auc_random"], res["auc_ssl"], res["auc_eval"]] + losses
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"[learn] a loss or AUC is not finite: {values}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[learn] the last SSL epoch loss {losses[-1]} "
                             f"is not below the first {losses[0]}")
    # the SSL probe above the random-init one is not gated: seed 0 misses
    # it on the card (PERF.md §6)
    want = dict.fromkeys(launches, 0)
    want.update(photometric_cuda=LEARN_K1, ntxent_forward_cuda=LEARN_SSL_STEPS,
                ntxent_backward_cuda=LEARN_SSL_STEPS)
    # K6 serves the demo's resnet18 wherever its batch norms run in train
    # mode: logged above, held in [main] and [bn]
    for name in r50_k6(0):
        want[name] = launches[name]
    if launches != want or variants["scratch"]:
        raise AssertionError(f"[learn] launches {launches}, K1 {variants}: "
                             f"expected {want}, K1 band only")
    rows = {"photometric": [k1_at_path_shape(
        LEARN_K1_SHAPE, "learn", "learn", "a view of the demo's batch")]}
    rows.update({key: [row] for key, row in k2_at_path_shape(
        LEARN_K2_SHAPE, "learn", "learn",
        np.random.default_rng(12)).items()})
    return launches, rows


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
    from sm3x_torch.data.synthetic import synthetic_paired_data
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

    data = synthetic_paired_data(STAGE2_CASES, canvas=320, seed=1)
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
    # K6 in the init pass alone: its extractor runs in train mode (the two
    # encoders, one view each), with no gradient; fit's is frozen in eval
    want.update(r50_k6(2 * steps, backward=False))
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


# K1 launches a supervised train step: one view a modality
SUPERVISED_PER_STEP = {"photometric_cuda": 2}
CSV_ROWS = ["Acc", "AUC", "Recall", "Spec", "Prec"]


def capture_logger(name: str):
    """A logger that keeps its records: (logger, [(level, message)])."""
    import logging

    logger = logging.getLogger(name)
    logger.handlers, logger.propagate = [], False
    logger.setLevel(logging.INFO)
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append((r.levelname, r.getMessage()))
    logger.addHandler(handler)
    return logger, records


def count_k1(fn, deltas: list):
    """`fn`, with K1's launches during each call appended to `deltas`."""
    from sm3x_torch.ops import augment_cuda as K

    def counted(*args):
        before = K.photometric_cuda.launches
        out = fn(*args)
        deltas.append(K.photometric_cuda.launches - before)
        return out

    return counted


def check_results_csv(path: str) -> None:
    """The released layout: `BWV-1` first, `DIAG avg` last, the five metric
    rows, every cell finite."""
    with open(path) as f:
        lines = f.read().splitlines()
    header = lines[0].split(",")
    rows = {ln.split(",")[0]: [float(v) for v in ln.split(",")[1:]]
            for ln in lines[1:]}
    if (header[0], header[1], header[-1]) != ("", "BWV-1", "DIAG avg") \
            or list(rows) != CSV_ROWS:
        raise AssertionError(f"{path}: not the released layout: {header[:3]} "
                             f"... {header[-1]}, rows {list(rows)}")
    if not all(len(v) == len(header) - 1 and all(map(math.isfinite, v))
               for v in rows.values()):
        raise AssertionError(f"{path}: a missing or non-finite cell")
    log(f"  results.csv: {len(header) - 1} columns {header[1]} .. "
        f"{header[-1]}, rows {list(rows)}, every cell finite; AUC '8 avg' "
        f"{rows['AUC'][-4]:.2f}")


def supervised_cfg(tag: str, finetune: str, amp: bool, batch: int):
    """An eval stage's config at the run.sh recipe: resnet50, 224x224, v4 /
    512, 1 head, ff 128, dropout 0.1, lr 1e-3, one epoch."""
    from sm3x_torch.core.config import EvalConfig

    cfg = EvalConfig()
    m, o, r = cfg.model, cfg.optim, cfg.run
    m.arch, m.finetune, m.mlc_proj, m.mlc_proj_dim = ("resnet50", finetune,
                                                      "v4", 512)
    m.num_heads, m.sa_dim_ff, m.sa_dropout = 1, 128, 0.1
    o.batch_size, o.base_lr, o.amp, o.epochs = batch, 1e-3, amp, 1
    cfg.data.img_sz, cfg.data.mean, cfg.data.std = (224, 224), MEAN, STD
    cfg.train_sz = cfg.test_sz = 224
    r.device, r.print_freq = "cuda", 10 ** 6
    r.log_path = os.path.join(LOGS, tag)
    shutil.rmtree(r.log_path, ignore_errors=True)
    os.makedirs(r.log_path)
    return cfg


def supervised_fit(tag: str, trainer, records, train, test) -> dict:
    """One epoch through `fit` and `write_results`, with every kernel count
    set to 0 just before and read just after: K1 twice a train step, all
    band, and never in an eval step; no other kernel; best_eval.pth written
    once, after the loop; results.csv in the released layout."""
    from sm3x_torch.ops import augment_cuda as K

    cfg = trainer.cfg
    steps = train.steps_per_epoch(cfg.optim.batch_size)
    eval_batches = test.steps_per_epoch(cfg.optim.batch_size)
    in_train, in_eval = [], []
    trainer.train_step = count_k1(trainer.train_step, in_train)
    trainer.eval_step = count_k1(trainer.eval_step, in_eval)
    counters, _ = kernel_counters()
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = trainer.fit(train, test)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    k1_variants = dict(K.photometric_cuda.variants)
    csv_path = os.path.join(cfg.run.log_path, "results.csv")
    trainer.write_results(test, csv_path)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"  one epoch via fit ({steps} train steps, then {eval_batches} eval "
        f"batches) in {wall:.2f} s; best val AUC_AVG {best:.4f}")
    log(f"  kernel launches in fit: {launches}; K1 by kernel {k1_variants}; "
        f"K1 a train step {in_train}, K1 an eval step {in_eval}")
    want = {fn.__name__: SUPERVISED_PER_STEP.get(fn.__name__, 0) * steps
            for fn in counters}
    if launches != want or in_train != [2] * steps \
            or in_eval != [0] * (2 * eval_batches):  # fit's pass and the CSV's
        raise AssertionError(f"launch counts {launches} (train {in_train}, "
                             f"eval {in_eval}), expected {want}")
    if k1_variants != {"band": launches["photometric_cuda"], "scratch": 0}:
        raise AssertionError(f"K1 kernels {k1_variants}, expected band only")
    said = [msg for _, msg in records]
    epoch_line = [i for i, msg in enumerate(said) if msg.startswith("Epoch 0:")]
    wrote = [i for i, msg in enumerate(said)
             if msg.startswith("wrote ") and "best_eval.pth" in msg]
    m = epoch_line and __import__("re").search(r"train loss (\S+),",
                                               said[epoch_line[0]])
    if not m or not math.isfinite(float(m.group(1))):
        raise AssertionError(f"no finite train loss in {said[-3:]}")
    if len(wrote) != 1 or wrote[0] < epoch_line[-1] or not os.path.exists(
            os.path.join(cfg.run.log_path, "best_eval.pth")):
        raise AssertionError("best_eval.pth must be written once, after the "
                             "epoch loop")
    log(f"  {said[epoch_line[0]]}")
    log(f"  best_eval.pth written once, after the loop: {said[wrote[0]]}")
    check_results_csv(csv_path)
    log(f"  peak device memory in fit and the CSV's pass: "
        f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated)")
    return launches


def supervised_times(trainer, train, test, profile_dir, profile_name) -> None:
    """Step ms over 8 more train steps (median, minimum; canvases uploaded
    before the clock), the eval pass's ms a batch, and the device's busy ms
    and launches a step under torch.profiler."""
    from sm3x_torch.train.supervised import upload_batch

    cfg = trainer.cfg
    batch = cfg.optim.batch_size

    def device_batches(data, epoch, shuffle=True):
        return [upload_batch(b, "cuda") + (
            torch.from_numpy(b.label).cuda().long(),)
            for b in data.batches(batch, epoch, cfg.run.seed, shuffle)]

    train_batches = device_batches(train, 1)
    times = timed_steps([
        lambda it=it, args=args: trainer.train_step(*args, 1000 + it)[0]
        for it, args in enumerate(train_batches)])
    step_s = statistics.median(times)
    log(f"  step time: median {step_s * 1e3:.1f} ms over {len(times)} steps, "
        f"min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f} (host "
        f"clock, synchronised; canvases uploaded before the clock); "
        f"{2 * batch / step_s:.1f} images/s (2 x batch per step)")
    eval_batches = device_batches(test, 0, shuffle=False)
    for args in eval_batches:  # warm-up
        trainer.eval_step(*args[:4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in eval_batches:
        trainer.eval_step(*args[:4])
    torch.cuda.synchronize()
    log(f"  eval pass: {(time.perf_counter() - t0) / len(eval_batches) * 1e3:.1f}"
        f" ms a batch of {batch} over {len(eval_batches)} batches (host "
        f"clock, one synchronise at the end)")
    profiled = train_batches[:3]
    step = lambda it: trainer.train_step(*profiled[it], 2000 + it)
    if profile_dir:
        profile_steps(step, len(profiled), profile_dir, profile_name)
    else:
        res = profile_device(step, len(profiled))
        log(f"  device busy {res['busy_ms']:.1f} ms a step of "
            f"{res['wall_ms']:.1f} ms on the host clock "
            f"({100 * res['busy_ms'] / res['wall_ms']:.1f}% busy), "
            f"{res['launches']:.0f} kernels and copies a step "
            f"(torch.profiler, {len(profiled)} steps)")


def snapshot(module) -> dict:
    return {k: v.clone() for k, v in module.state_dict().items()}


def phase_eval(profile_dir=None):
    """stage2_eval at the run.sh recipe, from [stage2]'s ckp_1.pth, float32
    with TF32 off. Returns the kernel launches of the epoch and, for
    [infer], the path of best_eval.pth with test canvases and the trainer's
    eval-step logits on them, taken while its weights are still the ones
    it wrote."""
    from sm3x_torch.core import prng
    from sm3x_torch.data.synthetic import (SyntheticPairedData,
                                           synthetic_paired_data)
    from sm3x_torch.ops.augment import FINETUNE_AUG
    from sm3x_torch.train import supervised
    from sm3x_torch.train.mlc_eval import MLCEvalTrainer
    from sm3x_torch.train.mlc_train import augment_pair
    from sm3x_torch.utils.checkpoint import load_pretrained_state
    import dataclasses

    cfg = supervised_cfg("eval", "projector", False, EVAL_BATCH)
    train = synthetic_paired_data(EVAL_TRAIN_CASES, canvas=320, seed=2)
    test = synthetic_paired_data(EVAL_TEST_CASES, canvas=320, seed=3)
    state = load_pretrained_state(os.path.join(LOGS, "stage2", "ckp_1.pth"))
    logger, records = capture_logger("chip_smoke.eval")
    trainer = MLCEvalTrainer(cfg, logger=logger, pretrained_state=state)
    log(f"[eval] stage2_eval: resnet50 frozen, --finetune projector, v4 / "
        f"512, 1 head, ff 128, dropout 0.1, batch {EVAL_BATCH}, lr 1e-3, "
        f"float32 (TF32 off), 224x224, {EVAL_TRAIN_CASES} train / "
        f"{EVAL_TEST_CASES} test cases, from [stage2]'s ckp_1.pth")
    biases = [f"prototypes.{i}.bias" for i in range(8)]
    warned = [msg for lvl, msg in records if lvl == "WARNING"]
    log(f"  keys the checkpoint lacks: {trainer.missing_keys}")
    if trainer.missing_keys != biases or warned != [
            f"Missing key in checkpoint: {k}" for k in biases]:
        raise AssertionError(f"expected only the prototype biases to be "
                             f"missing, with a warning each: {warned}")
    if trainer.optimizer.defaults["eps"] != 1e-8:
        raise AssertionError("the eval stage's AdamW eps is 1e-8")
    loaded = snapshot(trainer.model.extractor)

    launches = supervised_fit("eval", trainer, records, train, test)
    after = snapshot(trainer.model.extractor)
    same = all(torch.equal(after[k], v) for k, v in loaded.items())
    log(f"  extractor after fit: weights and running statistics "
        f"bit-identical to the checkpoint {same} ({len(loaded)} tensors)")
    if not same:
        raise AssertionError("the frozen extractor changed")
    canvases = supervised.upload_batch(
        next(test.batches(64, 0, shuffle=False)), "cuda")
    reference = dict(
        path=os.path.join(cfg.run.log_path, "best_eval.pth"),
        canvases=canvases,
        logits={n: trainer.eval_step(*(x[:n] for x in canvases))
                for n in (1, 64)})

    # a train step's predictions against a second forward on the same views:
    # the same seed gives the same views and the same dropout masks
    batch = next(train.batches(EVAL_BATCH, 5, cfg.run.seed))
    args = supervised.upload_batch(batch, "cuda")
    labels = torch.from_numpy(batch.label).cuda().long()
    seed = prng.step_seed(cfg.run.seed, 5, 0)
    aug = dataclasses.replace(FINETUNE_AUG, out_size=(224, 224))
    d, c = augment_pair(seed, *args, MEAN, STD, aug, False)
    with torch.no_grad():
        second = trainer.model(
            d, c, extractor_train=False, head_train=True,
            generator=prng.generator(prng.fold_in(seed, 2), "cuda"))[1]
    loss, preds = trainer.train_step(*args, labels, seed)
    for i, (got, want) in enumerate(zip(preds, second)):
        check_close(f"train step's predictions, label {i}", got, want,
                    rtol=1e-5, atol=1e-6)
    if not math.isfinite(float(loss)):
        raise AssertionError("non-finite loss")
    supervised_times(trainer, train, test, profile_dir, "profile_eval.txt")

    # --finetune all at batch 64, two steps: the stem stays as it was, its
    # batch norm still moves its running statistics, layer1-4 train
    cfg_all = supervised_cfg("eval_all", "all", False, 64)
    logger_all, _ = capture_logger("chip_smoke.eval_all")
    all_trainer = MLCEvalTrainer(cfg_all, logger=logger_all,
                                 pretrained_state=state)
    before = snapshot(all_trainer.model.extractor)
    torch.cuda.reset_peak_memory_stats()
    stats = supervised.run_train_epoch(
        all_trainer, SyntheticPairedData(128, canvas=320, seed=4), 0)
    peak = torch.cuda.max_memory_allocated()
    now = all_trainer.model.extractor.state_dict()
    stem = lambda k: ".encoder.conv1." in k or ".encoder.bn1." in k
    weight = lambda k: "running" not in k and "num_batches" not in k
    stem_same = all(torch.equal(now[k], v) for k, v in before.items()
                    if stem(k) and weight(k))
    stem_stats = [not torch.equal(now[k], v) for k, v in before.items()
                  if stem(k) and "running" in k]
    layers = [not torch.equal(now[k], v) for k, v in before.items()
              if ".encoder.layer" in k and weight(k)]
    log(f"  --finetune all, batch 64, 2 steps: loss {stats['loss']:.4f}; "
        f"stem weights bit-identical {stem_same}; stem running statistics "
        f"moved {sum(stem_stats)} of {len(stem_stats)}; layer1-4 tensors "
        f"moved {sum(layers)} of {len(layers)}; peak "
        f"{peak / 2 ** 30:.2f} GiB")
    if not (math.isfinite(stats["loss"]) and stem_same and all(stem_stats)
            and all(layers)):
        raise AssertionError("--finetune all: the stem must stay frozen with "
                             "moving statistics, and layer1-4 must train")
    del all_trainer, trainer
    torch.cuda.empty_cache()
    return launches, reference


def phase_probe(profile_dir=None) -> dict:
    """stage1_eval at the run.sh recipe, from [main]'s ckp_0.pth: --finetune
    fc under bf16 autocast."""
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.train.backbone_eval import BackboneEvalTrainer
    from sm3x_torch.utils.checkpoint import load_encoder_state

    cfg = supervised_cfg("probe", "fc", True, EVAL_BATCH)
    train = synthetic_paired_data(EVAL_TRAIN_CASES, canvas=320, seed=2)
    test = synthetic_paired_data(EVAL_TEST_CASES, canvas=320, seed=3)
    encoders = load_encoder_state(os.path.join(LOGS, "main", "ckp_0.pth"))
    logger, records = capture_logger("chip_smoke.probe")
    trainer = BackboneEvalTrainer(cfg, logger=logger, encoder_state=encoders)
    log(f"[probe] stage1_eval: two resnet50 frozen under 8 linear heads, "
        f"--finetune fc, batch {EVAL_BATCH}, lr 1e-3, bf16 autocast, "
        f"224x224, from [main]'s ckp_0.pth")
    backbones = lambda: {k: v.clone()
                         for k, v in trainer.model.state_dict().items()
                         if not k.startswith("classifier.")}
    loaded = backbones()
    if len(loaded) != len(encoders) or not all(
            torch.equal(loaded[k.replace(".encoder.", ".")], v.cuda())
            for k, v in encoders.items()):
        raise AssertionError("the backbones are not the checkpoint's")
    heads = snapshot(trainer.model.classifier)
    launches = supervised_fit("probe", trainer, records, train, test)
    after = backbones()
    same = all(torch.equal(after[k], v) for k, v in loaded.items())
    moved = sum(not torch.equal(v, heads[k])
                for k, v in trainer.model.classifier.state_dict().items())
    log(f"  backbones after fit: weights and running statistics "
        f"bit-identical to the checkpoint {same} ({len(loaded)} tensors); "
        f"head tensors moved {moved} of {len(heads)}")
    if not same or moved != len(heads):
        raise AssertionError("--finetune fc must train the heads alone")
    supervised_times(trainer, train, test, profile_dir, "profile_probe.txt")
    return launches


# bf16 serving and inference (the encoders under bf16 autocast, the head in
# float32) against the float32 forward of the same weights, on [eval]'s
# model, whose heads lean on their biases: the encoders' bf16 rounding
# reaches its logits at 2.5e-5 relative and its probabilities at 1.3e-4
# (H100). A planted fault, the head run in bf16 too, reads 1.8e-3 to
# 2.0e-3 and 9.2e-3 to 9.4e-3. Bounds between the two: the eight heads'
# logits within 2e-4 relative (Frobenius), each probability within 1e-3;
# [infer] plants the fault in every run and fails unless they catch it
BF16_LOGITS_REL, BF16_PROB_ATOL = 2e-4, 1e-3


def head_in_bf16(model, derm, clinic) -> list:
    """The planted fault: `model`'s forward with its head under bf16
    autocast too (a misplaced autocast region); the eight logits in
    float32."""
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        return [t.float() for t in model(derm, clinic)[1]]


def bf16_against_float32(logits16, logits32) -> tuple:
    """(relative Frobenius error of the eight heads' logits, max abs error
    of their probabilities) of a bf16 forward against the float32 one."""
    a = torch.cat([t.float().cpu() for t in logits16], dim=-1)
    b = torch.cat([t.float().cpu() for t in logits32], dim=-1)
    rel = float((a - b).norm() / b.norm())
    probs = [torch.softmax(t.float().cpu(), -1) - torch.softmax(
        u.float().cpu(), -1) for t, u in zip(logits16, logits32)]
    return rel, max(float(d.abs().max()) for d in probs)


def phase_infer(reference: dict) -> dict:
    """The inference API on [eval]'s best_eval.pth at the JAX package's
    default, bf16 (`build_evaluator()`), and in float32 (`amp=False`, TF32
    off): float32 against the trainer's eval step on the same images
    (`reference`, from [eval]) and the same forward on the CPU, bf16
    against the float32 eval step's logits, at batch 1 and 64; latency a
    call of each."""
    from sm3x_torch import api
    from sm3x_torch.ops.augment import eval_resize_batch

    path, args = reference["path"], reference["canvases"]
    models = {"bf16": api.load_weights(api.build_evaluator(), path, "cuda"),
              "float32": api.load_weights(api.build_evaluator(amp=False),
                                          path, "cuda")}
    if not models["bf16"].extractor.amp or models["float32"].extractor.amp:
        raise AssertionError("build_evaluator() must default to bf16")
    cpu_model = api.load_weights(api.build_evaluator(amp=False), path, "cpu")
    predict = {k: api.predict_fn(m) for k, m in models.items()}
    predict_cpu = api.predict_fn(cpu_model)
    counters, _ = kernel_counters()
    reset_counters()
    log("[infer] sm3x_torch.api on [eval]'s best_eval.pth: build_evaluator, "
        "load_weights, predict_fn on NHWC float batches; the default bf16 "
        "(encoders under bf16 autocast, head float32) and amp=False "
        "(float32, TF32 off)")
    latency = {}
    for n in (1, 64):
        # the images the eval step makes of these canvases
        d = eval_resize_batch(args[0][:n], args[1][:n], MEAN, STD, (224, 224))
        c = eval_resize_batch(args[2][:n], args[3][:n], MEAN, STD, (224, 224))
        want = reference["logits"][n]
        got = {k: fn(d, c) for k, fn in predict.items()}
        t0 = time.perf_counter()
        on_cpu = predict_cpu(d.cpu().numpy(), c.cpu().numpy())
        cpu_s = time.perf_counter() - t0
        for k, out in got.items():
            if (len(out) != 8 or out[0].shape != (n, 5)
                    or out[0].requires_grad
                    or out[0].dtype != torch.float32):
                raise AssertionError(f"predict_fn ({k}): eight float32 "
                                     f"logit tensors expected")
        for i in range(8):
            check_close(f"batch {n}, label {i}, float32 against the eval "
                        f"step", got["float32"][i], want[i], rtol=1e-5,
                        atol=1e-5)
            check_close(f"batch {n}, label {i}, float32 against the CPU",
                        got["float32"][i], on_cpu[i], rtol=1e-3, atol=1e-4)
        rel, prob = bf16_against_float32(got["bf16"], want)
        log(f"  batch {n}: bf16 against the float32 eval step: logits "
            f"{rel:.3e} relative (bound {BF16_LOGITS_REL:g}), probabilities "
            f"max abs err {prob:.3e} (bound {BF16_PROB_ATOL:g})")
        if not (rel <= BF16_LOGITS_REL and prob <= BF16_PROB_ATOL):
            raise AssertionError(f"bf16 inference at batch {n} is off the "
                                 f"float32 forward")
        rel_f, prob_f = bf16_against_float32(
            head_in_bf16(models["bf16"], d, c), want)
        log(f"  batch {n}: a planted fault, the head in bf16 too: logits "
            f"{rel_f:.3e} relative, probabilities max abs err {prob_f:.3e}")
        if rel_f <= BF16_LOGITS_REL and prob_f <= BF16_PROB_ATOL:
            raise AssertionError("the bf16 bounds let a bf16 head pass")
        for k, fn in predict.items():
            call = lambda fn=fn: fn(d, c)
            host = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            dev = device_ms(call, 20)
            latency[k, n] = dict(host_ms=statistics.median(host),
                                 host_ms_min=min(host), device_ms=dev)
            log(f"  batch {n}, {k}: latency a call "
                f"{statistics.median(host):.2f} ms on the host clock (median "
                f"of 10, synchronised; min {min(host):.2f}), {dev:.2f} ms "
                f"device time (20 calls in a row)")
        log(f"  batch {n}: the float32 forward on the CPU {cpu_s:.2f} s")
    if any(fn.launches for fn in counters):
        raise AssertionError("inference launches none of the kernels")
    log("  kernel launches at inference: none (no view is made)")
    return latency


# requests of raw images: the sizes of each call, and the buckets they take
SERVE_REQUESTS = {1: [1], 5: [8], 8: [8], 33: [128], 300: [128, 128, 128]}
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)     # [infer]'s bound on its logits
# a case's probabilities in another batch size's programs, against the case
# alone. float32 (TF32 off): summation order only. bf16: another batch
# size's cuDNN algorithms round an entry the other way here and there; on
# [eval]'s model that moves a probability by at most 3.0e-5 (H100, the
# batcher's 16 cases in bucket 32 against bucket 1), so the bound is 1e-4.
# Each check also holds its cases' rows apart by more than its bound plus
# the error it read, so that a row given to the wrong case cannot pass
SERVE_BATCH_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
                   "bf16": dict(rtol=0.0, atol=1e-4)}


def raw_images(n: int, seed: int) -> list:
    """Random uint8 RGB images of mixed sizes that fit canvas 320 once the
    25-pixel border is cropped (no resize on the host, so no decoder): each
    a colour of its own under noise of its own strength, so that the
    model's outputs tell the cases apart (uniform noise looks alike to it)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        shape = (int(rng.integers(100, 371)), int(rng.integers(100, 371)), 3)
        colour, noise = rng.uniform(0, 255, 3), rng.uniform(0, 96)
        out.append(np.clip(colour + noise * rng.standard_normal(
            shape, dtype=np.float32), 0, 255).astype(np.uint8))
    return out


def image_decoder():
    """'PIL', 'cv2' or None: what this machine can encode and decode an
    image with."""
    for name in ("PIL", "cv2"):
        try:
            __import__(name)
            return name
        except ImportError:
            pass
    return None


def encode_image(img: np.ndarray, fmt: str, decoder: str) -> bytes:
    """RGB array -> PNG or JPEG bytes with the decoder that is there."""
    if decoder == "PIL":
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format=fmt, quality=95)
        return buf.getvalue()
    import cv2

    ok, data = cv2.imencode("." + ("jpg" if fmt == "JPEG" else "png"),
                            img[:, :, ::-1])
    if not ok:
        raise AssertionError("cv2.imencode failed")
    return data.tobytes()


def host_ms(fn, reps: int = 20) -> tuple:
    """(median, minimum) ms of fn() on the host clock, each call ended by a
    synchronise, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times)


def graph_pool_bytes(segments=None) -> int:
    """Bytes of the allocator's segments that belong to a CUDA graphs'
    memory pool (torch.cuda.memory_snapshot)."""
    segments = torch.cuda.memory_snapshot() if segments is None else segments
    return sum(s["total_size"] for s in segments
               if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))


def describe_predictor(predictor, tag: str, held0: int, reserved0: int,
                       built_s: float) -> float:
    """The lines of a Predictor just built: its graphs, their memory pool
    and what the device holds; returns the pool's GiB."""
    from sm3x_torch import NUM_CLASSES

    gib = 2 ** 30
    weights = sum(p.numel() * p.element_size()
                  for p in predictor.model.state_dict().values())
    log(f"  {tag}: two resnet50, 224x224, canvas {predictor.canvas}, crop "
        f"{predictor.crop_amount}, buckets {predictor.buckets}; weights, "
        f"warm-ups and captures in {built_s:.2f} s")
    for b in predictor.buckets:
        g = predictor._graphs[b]
        log(f"  bucket {b}: one CUDA graph over static inputs "
            f"{tuple(g.static['derm'].shape)} uint8 x 2 and "
            f"{tuple(g.static['derm_hw'].shape)} int32 x 2, static output "
            f"{tuple(g.out.shape)} {str(g.out.dtype).split('.')[-1]}")
        if g.out.shape != (b, sum(NUM_CLASSES)) or g.out.dtype != torch.float32:
            raise AssertionError(f"bucket {b}: packed float32 output expected")
    if sorted(predictor._graphs) != [1, 8, 32, 128]:
        raise AssertionError("a graph a default bucket expected")
    segments = torch.cuda.memory_snapshot()
    in_pool = graph_pool_bytes(segments)
    log(f"  {tag}: the graphs' memory pool holds {in_pool / gib:.2f} GiB of "
        f"segments (torch.cuda.memory_snapshot), the allocator's other "
        f"segments {(sum(s['total_size'] for s in segments) - in_pool) / gib:.2f}"
        f" GiB")
    log(f"  {tag}: device memory {(torch.cuda.memory_allocated() - held0) / gib:.2f}"
        f" GiB held by the weights ({weights / gib:.2f} GiB), the four "
        f"graphs' pool and the static buffers; peak while warming up and "
        f"capturing {(torch.cuda.max_memory_allocated() - held0) / gib:.2f} "
        f"GiB; reserved {(torch.cuda.memory_reserved() - reserved0) / gib:.2f}"
        f" GiB after the warm-ups' cache was given back")
    return in_pool / gib


def eager_packed(predictor, arrays) -> torch.Tensor:
    """[infer]'s eager forward of `predictor.model` on canvases as `_call`
    gets them: eval_resize_batch, api.predict_fn's forward, a softmax a
    head."""
    from sm3x_torch import api
    from sm3x_torch.ops.augment import eval_resize_batch

    derm, derm_hw, clinic, clinic_hw = (
        torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)
    d = eval_resize_batch(derm, derm_hw, MEAN, STD, (224, 224))
    c = eval_resize_batch(clinic, clinic_hw, MEAN, STD, (224, 224))
    logits = api.predict_fn(predictor.model)(d, c)
    return torch.cat([torch.softmax(p.float(), dim=-1) for p in logits],
                     dim=-1)


def serve_requests(predictor, sizes, tag: str) -> dict:
    """Requests of `sizes` cases of raw images through `predict`, each
    dispatch against the eager forward on the same canvases at SERVE_TOL,
    the buckets each took as SERVE_REQUESTS says, rows summing to 1:
    {n: (derm, clinic, outputs)}."""
    from sm3x_torch import NUM_CLASSES

    seen = []
    call = predictor._call

    def spy(b, *arrays):
        out = call(b, *arrays)
        seen.append((b, arrays, np.concatenate(out, axis=-1)))
        return out

    predictor._call = spy
    results = {}
    try:
        for n in sizes:
            want_buckets = SERVE_REQUESTS[n]
            derm, clinic = raw_images(n, 100 + n), raw_images(n, 200 + n)
            seen.clear()
            out = predictor.predict(derm, clinic)
            results[n] = (derm, clinic, out)
            took = [b for b, _, _ in seen]
            if took != want_buckets:
                raise AssertionError(f"{n} cases took buckets {took}, "
                                     f"expected {want_buckets}")
            if [p.shape for p in out] != [(n, c) for c in NUM_CLASSES]:
                raise AssertionError(f"{n} cases: shapes "
                                     f"{[p.shape for p in out]}")
            sums = np.stack([p.sum(axis=-1) for p in out])
            if not (np.isfinite(sums).all()
                    and np.abs(sums - 1).max() < 1e-5):
                raise AssertionError(f"{n} cases: rows do not sum to 1")
            worst = 0.0
            for k, (b, arrays, packed) in enumerate(seen):
                worst = max(worst, check_close(
                    f"{tag}, {n} cases, dispatch {k} (bucket {b}): graph "
                    f"against the eager forward on the same canvases",
                    torch.from_numpy(packed),
                    eager_packed(predictor, arrays), **SERVE_TOL))
            log(f"  {tag}: {n} cases -> buckets {took}; rows sum to 1 "
                f"within {np.abs(sums - 1).max():.1e}; graph against eager "
                f"max abs err {worst:.3e}")
    finally:
        del predictor._call
    return results


def serve_latency(predictor, tag: str) -> dict:
    """Latency at 1 / 8 / 32 / 128 cases: the whole predict call, the
    upload + replay + fetch, the eager forward; the device's busy time of
    each."""
    from sm3x_torch.ops.augment import eval_resize_batch

    serve_ms = {}
    for n in (1, 8, 32, 128):
        derm, clinic = raw_images(n, 300 + n), raw_images(n, 400 + n)
        dc, dhw = predictor._canvases(derm)
        cc, chw = predictor._canvases(clinic)
        arrays = (dc, dhw, cc, chw)
        on_card = [torch.from_numpy(a).cuda() for a in arrays]

        def eager():
            d = eval_resize_batch(on_card[0], on_card[1], MEAN, STD,
                                  (224, 224))
            c = eval_resize_batch(on_card[2], on_card[3], MEAN, STD,
                                  (224, 224))
            with torch.inference_mode():
                preds = predictor.model(d, c)[1]
                return torch.cat([torch.softmax(p.float(), dim=-1)
                                  for p in preds], dim=-1).cpu()

        whole = host_ms(lambda: predictor.predict(derm, clinic))
        replay = host_ms(lambda: predictor._call(n, *arrays))
        plain = host_ms(eager)
        busy_g = profile_device(lambda _: predictor._call(n, *arrays), 5)
        busy_e = profile_device(lambda _: eager(), 5)
        serve_ms[n] = dict(predict_ms=whole[0], predict_ms_min=whole[1],
                           replay_ms=replay[0], replay_ms_min=replay[1],
                           eager_ms=plain[0], eager_ms_min=plain[1],
                           replay_busy_ms=busy_g["busy_ms"],
                           eager_busy_ms=busy_e["busy_ms"],
                           replay_launches=busy_g["launches"],
                           eager_launches=busy_e["launches"])
        log(f"  {tag}, {n} cases, latency a call on the host clock (median "
            f"of 20, min): predict {whole[0]:.2f} / {whole[1]:.2f} ms (crop "
            f"and letterbox on the host included); upload + graph replay + "
            f"fetch {replay[0]:.2f} / {replay[1]:.2f} ms, device busy "
            f"{busy_g['busy_ms']:.2f} ms in {busy_g['launches']:.0f} kernels "
            f"and copies; eager forward + fetch, canvases already on the "
            f"card, {plain[0]:.2f} / {plain[1]:.2f} ms, device busy "
            f"{busy_e['busy_ms']:.2f} ms in {busy_e['launches']:.0f}")
    return serve_ms


def least_gap(rows) -> float:
    """The least max-abs distance between two of `rows` (packed
    probabilities, a case each)."""
    rows = [np.asarray(r, dtype=np.float64).ravel() for r in rows]
    return min(float(np.abs(a - b).max())
               for i, a in enumerate(rows) for b in rows[i + 1:])


def rows_apart(what: str, rows, tol: dict, err: float) -> None:
    """Fails unless every two of `rows` are further apart than `tol`'s
    bound on a probability plus `err`, the error its check read: a row of
    another case, off its own by about `err`, then fails the check."""
    gap, reach = least_gap(rows), tol["atol"] + tol["rtol"] + err
    log(f"  {what}: the least distance between two cases' rows {gap:.3e} "
        f"(must exceed the bound plus the error read, {reach:.3e})")
    if not gap > reach:
        raise AssertionError(f"{what}: the cases' rows are too alike for "
                             f"the check to tell them apart")


def serve_batching(predictor, results: dict, tag: str) -> None:
    """On a Predictor that served `results` (serve_requests): a padded
    request against the case alone and the 300 cases against their chunks
    at SERVE_BATCH_TOL[tag], one device-to-host copy a dispatch
    (torch.profiler), then the HTTP server on 127.0.0.1: /healthz, /labels,
    400, 404, 413, 16 threads through the batcher and POST /predict (where
    PIL or cv2 is there) against a direct predict of each case, stop()."""
    import json as _json
    import threading
    import urllib.error
    import urllib.request

    from sm3x_torch import CLASSES_NAME, NUM_CLASSES
    from sm3x_torch.serve_http import PredictionServer
    from sm3x_torch.utils.timing import _profile, device_events

    tol = SERVE_BATCH_TOL[tag]
    # a padded request against the same case alone (bucket 8 against 1)
    derm, clinic, out5 = results[5]
    alone = predictor.predict(derm[2:3], clinic[2:3])
    err = check_close(f"{tag}, case 2 of the 5-case request against the "
                      f"case alone", torch.from_numpy(np.concatenate(
                          [p[2:3] for p in out5], -1)),
                      torch.from_numpy(np.concatenate(alone, -1)), **tol)
    rows_apart(f"{tag}, the 5-case request", np.concatenate(out5, -1), tol,
               err)
    # the 300 cases against their chunks of 128
    derm, clinic, out300 = results[300]
    chunks = [predictor.predict(derm[s:s + 128], clinic[s:s + 128])
              for s in (0, 128, 256)]
    joined = [np.concatenate([c[h] for c in chunks]) for h in range(8)]
    same = all(np.array_equal(a, b) for a, b in zip(out300, joined))
    log(f"  {tag}: 300 cases against their chunks of 128, 128 and 44: "
        f"identical bits {same}")
    if not same:
        raise AssertionError("a chunked request differs from its chunks")

    # copies of a dispatch under the profiler, over three dispatches
    derm, clinic, _ = results[5]
    predictor.predict(derm, clinic)
    n_prof = 3
    prof, _ = _profile(lambda _: predictor.predict(derm, clinic), n_prof)
    rows, _field = device_events(prof)
    d2h = sum(e.count for e in rows if "memcpy dtoh" in e.key.lower())
    h2d = sum(e.count for e in rows if "memcpy htod" in e.key.lower())
    kernels = sum(e.count for e in rows if "memcpy" not in e.key.lower()
                  and "memset" not in e.key.lower())
    log(f"  {tag}: {n_prof} dispatches of 5 cases under torch.profiler: "
        f"{d2h} device-to-host copies (one a dispatch), {h2d} host-to-device "
        f"copies (four a dispatch queued; the profiler does not always "
        f"report the first ones of its window), {kernels / n_prof:.0f} "
        f"kernels a graph")
    if d2h != n_prof or h2d > 4 * n_prof:
        raise AssertionError(f"{n_prof} dispatches made {d2h} device-to-host "
                             f"and {h2d} host-to-device copies, expected "
                             f"{n_prof} and at most {4 * n_prof}")

    # the HTTP server
    decoder = image_decoder()
    log(f"  {tag}: image decoder on this machine: "
        f"{decoder or 'neither PIL nor cv2'}")
    dispatched = []
    direct_predict = predictor.predict

    def counting(derm, clinic):
        dispatched.append(len(derm))
        return direct_predict(derm, clinic)

    predictor.predict = counting
    server = PredictionServer(predictor, "127.0.0.1", 0, max_batch=128,
                              max_wait_ms=100.0).start()
    capped = PredictionServer(predictor, "127.0.0.1", 0, batching=False,
                              max_body_mb=0.001).start()
    base = f"http://127.0.0.1:{server.port}"

    def status(url, data=None):
        req = urllib.request.Request(url, data=data, headers={
            "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, _json.load(r)
        except urllib.error.HTTPError as e:
            return e.code, _json.load(e)

    try:
        health = status(f"{base}/healthz")
        labels = status(f"{base}/labels")
        bad = status(f"{base}/predict", b'{"cases": [{"derm": "!!"}]}')
        missing = status(f"{base}/nowhere")
        big = status(f"http://127.0.0.1:{capped.port}/predict",
                     _json.dumps({"cases": [{"derm": "x" * 4096,
                                             "clinic": "x" * 4096}]}).encode())
        log(f"  {tag}: server on 127.0.0.1:{server.port}: /healthz {health}, "
            f"/labels {labels[0]}, a malformed body {bad[0]}, an unknown "
            f"path {missing[0]}, a body over a 1 KiB cap {big[0]}")
        if (health != (200, {"status": "ok", "labels": 8})
                or labels != (200, {"labels": list(CLASSES_NAME),
                                    "num_classes": list(NUM_CLASSES)})
                or (bad[0], missing[0], big[0]) != (400, 404, 413)):
            raise AssertionError("the server's answers are not as documented")

        # 16 callers at once through the batcher, one case each
        n_callers = 16
        derm, clinic = raw_images(n_callers, 500), raw_images(n_callers, 600)
        want = [direct_predict(derm[i:i + 1], clinic[i:i + 1])
                for i in range(n_callers)]
        got, errors = [None] * n_callers, []
        barrier = threading.Barrier(n_callers)
        dispatched.clear()

        def caller(i):
            try:
                barrier.wait(30)
                got[i] = server._batcher.predict(derm[i:i + 1],
                                                 clinic[i:i + 1])
            except Exception as e:  # reported below, by every caller's row
                errors.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(n_callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if errors or any(g is None for g in got):
            raise AssertionError(f"batched callers failed: {errors[:3]}")
        worst, err = 0.0, 0.0
        for i in range(n_callers):
            a = np.concatenate(got[i], -1)
            b = np.concatenate(want[i], -1)
            if a.shape != b.shape:
                raise AssertionError(f"caller {i} got {a.shape}")
            err = max(err, float(np.abs(a - b).max()))
            worst = max(worst, float((np.abs(a - b) / (
                tol["atol"] + tol["rtol"] * np.abs(b))).max()))
        log(f"  {tag}: {n_callers} threads through the batcher at once: "
            f"{len(dispatched)} dispatches of {dispatched} cases; each "
            f"caller's rows against a direct predict of its case, max abs "
            f"err {err:.3e}, worst err/bound {worst:.3f} (rtol "
            f"{tol['rtol']:g}, atol {tol['atol']:g})")
        if worst > 1.0 or sum(dispatched) != n_callers \
                or not len(dispatched) < n_callers:
            raise AssertionError("the batcher must give every caller its own "
                                 "rows in fewer dispatches than callers")
        rows_apart(f"{tag}, the {n_callers} callers' cases",
                   [np.concatenate(w, -1) for w in want], tol, err)

        if decoder:
            import base64

            cases = [{"derm": base64.b64encode(encode_image(
                          derm[i], fmt, decoder)).decode(),
                      "clinic": base64.b64encode(encode_image(
                          clinic[i], fmt, decoder)).decode()}
                     for i, fmt in ((0, "PNG"), (1, "JPEG"))]
            code, body = status(f"{base}/predict",
                                _json.dumps({"cases": cases}).encode())
            if code != 200 or len(body["predictions"]) != 2:
                raise AssertionError(f"POST /predict: {code} {body}")
            png = np.concatenate([body["predictions"][0][name]
                                  for name in CLASSES_NAME])
            check_close(f"{tag}, POST /predict, the PNG case against a "
                        f"direct predict (lossless)", torch.from_numpy(png),
                        torch.from_numpy(np.concatenate(want[0], -1)[0]),
                        **tol)
            jpg = body["predictions"][1]
            if set(jpg) != set(CLASSES_NAME) or not all(
                    abs(sum(v) - 1) < 1e-4 for v in jpg.values()):
                raise AssertionError("POST /predict: the JPEG case's rows")
            log(f"  {tag}: POST /predict with a PNG and a JPEG case: 200, "
                f"eight named rows a case, each summing to 1")
        else:
            log("  POST /predict with encoded images: not run here (no "
                "encoder to make the bodies); the CPU tests hold the round "
                "trip (tests/test_torch_serve.py)")
    finally:
        server.stop()
        capped.stop()
        del predictor.predict
    batcher = server._batcher
    if batcher._thread.is_alive() or not batcher.q.empty():
        raise AssertionError("stop() left the batcher's thread or a request")
    try:
        batcher.predict(derm[:1], clinic[:1])
        raise AssertionError("a stopped batcher took a request")
    except RuntimeError as e:
        log(f"  {tag}: stop() returned, no handler left waiting; a later "
            f"request is refused: {e}")


def phase_serve(reference: dict) -> dict:
    """The serving path on [eval]'s best_eval.pth: `Predictor` (a CUDA graph
    a bucket) in float32 (`amp=False`), then at its default, bf16
    (`from_checkpoint`): each against its eager forward, serve_batching at
    its tolerance, bf16 against float32."""
    from sm3x_torch import api
    from sm3x_torch.serve import Predictor

    counters, _ = kernel_counters()
    reset_counters()
    log("[serve] sm3x_torch.serve.Predictor on [eval]'s best_eval.pth: "
        "float32 (amp=False, TF32 off), then the default, bf16 (the encoders "
        "under bf16 autocast, the head and softmax float32)")
    pool, latency, outputs = {}, {}, {}
    for tag in ("float32", "bf16"):
        t_leg = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held0 = torch.cuda.memory_allocated()
        reserved0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        if tag == "bf16":
            predictor = Predictor.from_checkpoint(reference["path"], mean=MEAN,
                                                  std=STD, device="cuda")
            if not predictor.model.extractor.amp:
                raise AssertionError("Predictor.from_checkpoint must serve "
                                     "bf16 by default")
        else:
            predictor = Predictor(api.load_weights(
                api.build_evaluator(amp=False), reference["path"], "cuda"),
                MEAN, STD)
        torch.cuda.synchronize()
        pool[tag] = describe_predictor(predictor, tag, held0, reserved0,
                                       time.perf_counter() - t0)
        outputs[tag] = serve_requests(predictor, tuple(SERVE_REQUESTS), tag)
        latency[tag] = serve_latency(predictor, tag)
        t_batching = time.perf_counter()
        serve_batching(predictor, outputs[tag], tag)
        log(f"  {tag}: the leg took {time.perf_counter() - t_leg:.1f} s, "
            f"serve_batching {time.perf_counter() - t_batching:.1f} s of it")
        del predictor
        gc.collect()    # the server's reference cycles hold the graphs
    for n in SERVE_REQUESTS:
        a = np.concatenate(outputs["bf16"][n][2], -1)
        b = np.concatenate(outputs["float32"][n][2], -1)
        err = float(np.abs(a - b).max())
        log(f"  {n} cases: bf16 probabilities against float32 max abs err "
            f"{err:.3e} (bound {BF16_PROB_ATOL:g})")
        if not err <= BF16_PROB_ATOL:
            raise AssertionError("bf16 serving is off the float32 forward")
    for n in (1, 8, 32, 128):
        log(f"  {n} cases, bf16 against float32: predict "
            f"{latency['bf16'][n]['predict_ms']:.2f} against "
            f"{latency['float32'][n]['predict_ms']:.2f} ms, upload + replay "
            f"+ fetch {latency['bf16'][n]['replay_ms']:.2f} against "
            f"{latency['float32'][n]['replay_ms']:.2f} ms, replay busy "
            f"{latency['bf16'][n]['replay_busy_ms']:.2f} against "
            f"{latency['float32'][n]['replay_busy_ms']:.2f} ms")
    log(f"  the graphs' pool: bf16 {pool['bf16']:.2f} GiB against float32 "
        f"{pool['float32']:.2f} GiB")
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  kernel launches while serving: {launches} (no view is made)")
    if any(launches.values()):
        raise AssertionError("serving launches none of the kernels")
    torch.cuda.empty_cache()
    return dict(launches=launches, latency=latency, pool_gib=pool)


# [export]: the exporter's default buckets, the requests the fresh
# interpreter serves from the artifact and the buckets each takes (37: a
# chunk of 32 and one of 5 padded to 8), the float32 leg's one bucket, and
# what loading and serving an artifact must not import
EXPORT_BUCKETS = (1, 8, 32)
EXPORT_REQUESTS = {1: [1], 8: [8], 32: [32], 37: [32, 8]}
EXPORT_FLOAT32 = {5: [8], 8: [8]}
MODEL_CODE = ("sm3x_torch.models", "sm3x_torch.train", "sm3x_torch.api",
              "sm3x", "jax")
EXPORT_DIR = os.path.join(LOGS, "export")


def export_images(n: int) -> tuple:
    return raw_images(n, 700 + n), raw_images(n, 800 + n)


def http_images() -> tuple:
    return raw_images(2, 900), raw_images(2, 901)


def model_code_loaded() -> list:
    return sorted(m for m in sys.modules
                  if any(m == k or m.startswith(k + ".") for k in MODEL_CODE))


def graph_latency(predictor, sizes, busy: bool) -> dict:
    """Upload + graph replay + fetch at each of `sizes` cases (host clock,
    median and minimum of 20) and, with `busy`, the replay's device busy
    time (torch.profiler, 5 calls), on canvases made once."""
    out = {}
    for n in sizes:
        dc, dhw = predictor._canvases(raw_images(n, 300 + n))
        cc, chw = predictor._canvases(raw_images(n, 400 + n))
        arrays = (dc, dhw, cc, chw)
        replay = host_ms(lambda: predictor._call(n, *arrays))
        out[n] = dict(replay_ms=replay[0], replay_ms_min=replay[1])
        if busy:
            prof = profile_device(lambda _: predictor._call(n, *arrays), 5)
            out[n].update(replay_busy_ms=prof["busy_ms"],
                          replay_launches=prof["launches"])
    return out


def serve_export_requests(predictor, requests: dict, save=None) -> dict:
    """{n: packed probabilities} of `requests` (n -> the buckets it must
    take) through `predict`; with `save`, each also to save % n."""
    seen, outs = [], {}
    call = predictor._call

    def spy(b, *arrays):
        seen.append(b)
        return call(b, *arrays)

    predictor._call = spy
    try:
        for n, want in requests.items():
            seen.clear()
            outs[n] = np.concatenate(predictor.predict(*export_images(n)), -1)
            if seen != want:
                raise AssertionError(f"{n} cases took buckets {seen}, "
                                     f"expected {want}")
            if save:
                np.save(save % n, outs[n])
    finally:
        del predictor._call
    return outs


def conv_weight(params) -> dict:
    """Shape, strides and layout of the first 4-D parameter (the derm
    encoder's stem convolution)."""
    w = next(v for v in params if v.dim() == 4)
    return dict(shape=list(w.shape), stride=list(w.stride()),
                channels_last=w.is_contiguous(
                    memory_format=torch.channels_last), dtype=str(w.dtype))


def export_worker(art: str) -> int:
    """`--export-worker DIR`, [export]'s fresh interpreter: ExportedPredictor
    on DIR/bf16 and DIR/float32, with no model code imported; the requests'
    probabilities to DIR/*.npy, the load and capture seconds, the graphs,
    the memory and the modules loaded to DIR/worker.json."""
    from sm3x_torch.export import ExportedPredictor

    marks = []
    start = ExportedPredictor._start

    def timed_start(self):
        marks.append(time.perf_counter())
        start(self)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    ExportedPredictor._start = timed_start
    out = {}
    t0 = time.perf_counter()
    p = ExportedPredictor(os.path.join(art, "bf16"))
    out["load_s"], out["capture_s"] = marks[0] - t0, marks[1] - marks[0]
    out["pool_gib"] = graph_pool_bytes() / 2 ** 30
    out["held_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    out["graphs"] = {b: [list(g.static["derm"].shape), list(g.out.shape),
                         str(g.out.dtype)] for b, g in p._graphs.items()}
    out["conv_weight"] = conv_weight(p._programs[1].parameters())
    serve_export_requests(p, EXPORT_REQUESTS,
                          os.path.join(art, "bf16_%d.npy"))
    np.save(os.path.join(art, "bf16_http.npy"),
            np.concatenate(p.predict(*http_images()), -1))
    del p
    p32 = ExportedPredictor(os.path.join(art, "float32"))
    serve_export_requests(p32, EXPORT_FLOAT32,
                          os.path.join(art, "float32_%d.npy"))
    out["model_code_loaded"] = model_code_loaded()
    with open(os.path.join(art, "worker.json"), "w") as f:
        json.dump(out, f)
    return 1 if out["model_code_loaded"] else 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_export_server(path: str, log_path: str):
    """`python -m sm3x_torch.serve_http --exported-path PATH` on a free
    loopback port, its output to `log_path`: (process, base url)."""
    port = free_port()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "sm3x_torch.serve_http",
             "--exported-path", path, "--port", str(port)], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), stdout=out,
            stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}"


def post_to_export_server(proc, base: str, log_path: str, decoder):
    """Wait for the server's /healthz, then POST the two http_images()
    cases as PNG: the packed (2, sum C_i) answer."""
    import base64
    import urllib.error
    import urllib.request

    from sm3x_torch import CLASSES_NAME

    deadline = time.perf_counter() + 300
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"the server exited ({proc.returncode}): "
                                 f"{open(log_path).read()[-2000:]}")
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
                if r.status == 200:
                    break
        except (urllib.error.URLError, OSError):
            pass
        if time.perf_counter() > deadline:
            raise AssertionError("the server did not answer /healthz")
        time.sleep(0.5)
    derm, clinic = http_images()
    cases = [{"derm": base64.b64encode(encode_image(
                  derm[i], "PNG", decoder)).decode(),
              "clinic": base64.b64encode(encode_image(
                  clinic[i], "PNG", decoder)).decode()} for i in range(2)]
    req = urllib.request.Request(
        f"{base}/predict", data=json.dumps({"cases": cases}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.load(r)
    return np.array([np.concatenate([case[name] for name in CLASSES_NAME])
                     for case in body["predictions"]], dtype=np.float32)


def phase_export(reference: dict) -> dict:
    """The AOT artifact of [eval]'s best_eval.pth: sm3x_torch.export's CLI
    at its defaults (bf16, buckets 1 / 8 / 32, on the card), a float32
    artifact of bucket 8 and one for the CPU, which the card must refuse;
    a fresh interpreter serves the artifacts (a CUDA graph a bucket, no
    model code imported), the HTTP server serves it over the loopback, and
    both are held against the live Predictor on the same images, beside
    whose latency and pool theirs are printed."""
    from sm3x_torch import api, export
    from sm3x_torch.serve import Predictor

    counters, _ = kernel_counters()
    reset_counters()
    art = EXPORT_DIR
    shutil.rmtree(art, ignore_errors=True)
    log("[export] sm3x_torch.export on [eval]'s best_eval.pth (two resnet50, "
        "224x224, canvas 320): the CLI at its defaults, bf16, buckets "
        f"{list(EXPORT_BUCKETS)}, on the card")
    marks = []
    real_export, real_save = torch.export.export, torch.export.save

    def export_spy(*a, **k):
        marks.append(time.perf_counter())
        return real_export(*a, **k)

    def save_spy(*a, **k):
        marks.append(time.perf_counter())
        real_save(*a, **k)
        marks.append(time.perf_counter())

    torch.export.export, torch.export.save = export_spy, save_spy
    t0 = time.perf_counter()
    try:
        export.main(["--pretrain-path", reference["path"], "--out",
                     os.path.join(art, "bf16")])
    finally:
        torch.export.export, torch.export.save = real_export, real_save
    cli_s = time.perf_counter() - t0
    with open(os.path.join(art, "bf16", "manifest.json")) as f:
        manifest = json.load(f)
    keys = {"buckets", "image_size", "canvas", "crop_amount", "mean", "std",
            "num_classes", "platforms"}     # sm3x/export.py's manifest
    if (set(manifest) != keys or manifest["buckets"] != list(EXPORT_BUCKETS)
            or manifest["platforms"] != ["cuda"]):
        raise AssertionError(f"manifest {manifest}")
    mb = {}
    for i, b in enumerate(EXPORT_BUCKETS):
        t_export, t_save, t_saved = marks[3 * i:3 * i + 3]
        mb[b] = os.path.getsize(os.path.join(
            art, "bf16", f"fwd_b{b}_cuda.pt2")) / 1e6
        log(f"  bucket {b}: export and lowering to ATen "
            f"{t_save - t_export:.2f} s, write {t_saved - t_save:.2f} s, "
            f"fwd_b{b}_cuda.pt2 {mb[b]:.1f} MB")
    log(f"  the CLI took {cli_s:.2f} s in all (the weights' load "
        f"included); the artifact {sum(mb.values()):.1f} MB")

    decoder = image_decoder()
    server = None
    if decoder:
        log_path = os.path.join(art, "server.log")
        server, base = start_export_server(os.path.join(art, "bf16"),
                                           log_path)
        log(f"  started python -m sm3x_torch.serve_http --exported-path "
            f"... on {base}")
    try:
        model32 = api.load_weights(api.build_evaluator(amp=False),
                                   reference["path"], "cuda")
        t0 = time.perf_counter()
        export.export_predictor(model32, os.path.join(art, "float32"),
                                buckets=(8,))
        del model32
        # the planted fault's artifact: any model will do, the refusal
        # comes before a program is read
        t1 = time.perf_counter()
        small = api.build_evaluator("resnet18", mlc_proj_dim=32,
                                    sa_dim_ff=16).cuda()
        export.export_predictor(small, os.path.join(art, "cpu"),
                                buckets=(1,), image_size=48, canvas=64,
                                platforms=("cpu",))
        log(f"  float32 (amp=False), bucket 8, on the card: "
            f"{t1 - t0:.2f} s; a ResNet-18 evaluator on the card exported "
            f"for the CPU, bucket 1: {time.perf_counter() - t1:.2f} s")
        del small
        try:
            export.ExportedPredictor(os.path.join(art, "cpu"), device="cuda")
            raise AssertionError("an artifact for the CPU loaded on the card")
        except ValueError as e:
            log(f"  planted fault, the CPU's artifact on the card: refused: "
                f"{e}")
        posted = None
        if server is not None:
            posted = post_to_export_server(server, base, log_path, decoder)
    finally:
        if server is not None:
            server.terminate()
            try:
                server.wait(30)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait(30)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--export-worker", art], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    worker_s = time.perf_counter() - t0
    with open(os.path.join(art, "worker.json")) as f:
        got = json.load(f)
    log(f"  a fresh interpreter ({worker_s:.1f} s in all): ExportedPredictor"
        f" loaded the three programs in {got['load_s']:.2f} s and warmed and "
        f"captured their graphs in {got['capture_s']:.2f} s; model code "
        f"loaded: {got['model_code_loaded'] or 'none'} (of {list(MODEL_CODE)})")
    if res.returncode != 0 or got["model_code_loaded"]:
        raise AssertionError(f"the fresh interpreter failed (rc "
                             f"{res.returncode}) or loaded model code")
    for b, (static, out, dtype) in sorted(got["graphs"].items()):
        log(f"  bucket {b}: one CUDA graph over static inputs {static} uint8 "
            f"x 2 and int32 sizes, static output {out} {dtype}")
    if sorted(int(b) for b in got["graphs"]) != list(EXPORT_BUCKETS):
        raise AssertionError("a graph a bucket expected")

    def load(tag, n):
        return np.load(os.path.join(art, f"{tag}_{n}.npy"))

    t0 = time.perf_counter()
    held0, pool0 = torch.cuda.memory_allocated(), graph_pool_bytes()
    live = Predictor.from_checkpoint(reference["path"], mean=MEAN, std=STD,
                                     buckets=EXPORT_BUCKETS, device="cuda")
    torch.cuda.synchronize()
    live_s = time.perf_counter() - t0
    live_pool = (graph_pool_bytes() - pool0) / 2 ** 30
    live_held = (torch.cuda.memory_allocated() - held0) / 2 ** 30
    live_conv = conv_weight(live.model.parameters())
    log(f"  the stem convolution's weight: exported {got['conv_weight']}, "
        f"live {live_conv}")
    tol = SERVE_BATCH_TOL["bf16"]
    want = serve_export_requests(live, EXPORT_REQUESTS)
    err = 0.0
    for n in EXPORT_REQUESTS:
        err = max(err, check_close(
            f"bf16, {n} cases: the exported graphs against the live "
            f"Predictor's", torch.from_numpy(load("bf16", n)),
            torch.from_numpy(want[n]), **tol))
    rows_apart("bf16, the 37 cases", want[37], tol, err)
    if posted is not None:
        direct = load("bf16", "http")
        check_close("POST /predict of 2 PNG cases to the server over the "
                    "artifact against the fresh interpreter's direct call",
                    torch.from_numpy(posted), torch.from_numpy(direct), **tol)
    else:
        log("  POST /predict: not run here (neither PIL nor cv2 to encode "
            "the bodies); tests/test_torch_aot_export.py holds it")
    # the latency of both in this process, in turns after a warm-up:
    # exported, live, live, exported (the device busy time in the first
    # turn of each)
    t0 = time.perf_counter()
    exported = export.ExportedPredictor(os.path.join(art, "bf16"))
    log(f"  the artifact loaded and captured here too, in "
        f"{time.perf_counter() - t0:.2f} s, for the latency")
    sizes = (1, 8, 32)
    for p in (exported, live):  # the clocks up after the load's idle card
        graph_latency(p, sizes[-1:], False)
    turns = [graph_latency(exported, sizes, True),
             graph_latency(live, sizes, True),
             graph_latency(live, sizes, False),
             graph_latency(exported, sizes, False)]
    latency = {}
    for tag, (a, b) in (("exported", (turns[0], turns[3])),
                        ("live", (turns[1], turns[2]))):
        latency[tag] = {n: dict(a[n], replay_ms=(a[n]["replay_ms"]
                                                 + b[n]["replay_ms"]) / 2,
                                turns_ms=[a[n]["replay_ms"],
                                          b[n]["replay_ms"]])
                        for n in sizes}
    for n in sizes:
        a, b = latency["exported"][n], latency["live"][n]
        log(f"  {n} cases, exported against live: upload + replay + fetch "
            f"{a['replay_ms']:.2f} against {b['replay_ms']:.2f} ms (the "
            f"mean of two turns' medians of 20: {a['turns_ms'][0]:.2f}, "
            f"{a['turns_ms'][1]:.2f} against {b['turns_ms'][0]:.2f}, "
            f"{b['turns_ms'][1]:.2f}; {a['replay_ms'] / b['replay_ms']:.3f}x"
            f"), replay busy {a['replay_busy_ms']:.2f} against "
            f"{b['replay_busy_ms']:.2f} ms "
            f"({a['replay_busy_ms'] / b['replay_busy_ms']:.3f}x) in "
            f"{a['replay_launches']:.0f} against {b['replay_launches']:.0f} "
            f"kernels and copies")
    log(f"  the graphs' pool: exported {got['pool_gib']:.2f} GiB against "
        f"live {live_pool:.2f} GiB (graph pools held before it, not "
        f"counted: {pool0 / 2 ** 30:.2f} GiB); device memory held "
        f"{got['held_gib']:.2f}"
        f" against {live_held:.2f} GiB (a program holds its own weights, "
        f"a bucket each); the live Predictor built in {live_s:.2f} s")
    del live, exported
    gc.collect()
    torch.cuda.empty_cache()
    live32 = Predictor(api.load_weights(api.build_evaluator(amp=False),
                                        reference["path"], "cuda"),
                       MEAN, STD, buckets=(8,))
    want32 = serve_export_requests(live32, EXPORT_FLOAT32)
    for n in EXPORT_FLOAT32:
        check_close(f"float32, {n} cases: the exported graph against the "
                    f"live Predictor's", torch.from_numpy(load("float32", n)),
                    torch.from_numpy(want32[n]),
                    **SERVE_BATCH_TOL["float32"])
    del live32
    gc.collect()
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  kernel launches while exporting and serving: {launches} (no "
        f"view is made)")
    if any(launches.values()):
        raise AssertionError("the export path launches none of the kernels")
    shutil.rmtree(art, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(launches=launches, latency=latency,
                pool_gib=dict(exported=got["pool_gib"], live=live_pool))


FEED_CASES, FEED_STEPS = 1024, 8
FEEDS = ("host", "resident", "prefetch")


def phase_feed() -> dict:
    """[main]'s recipe under each --device-feed from one seed: the batches,
    the losses and the K1 launches must not depend on the feed."""
    import threading

    from sm3x_torch.core import prng
    from sm3x_torch.core.config import DataConfig
    from sm3x_torch.data.device_data import DeviceData
    from sm3x_torch.data.prefetch import (PrefetchData, resident_nbytes,
                                          to_device, wrap_from_config)
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.train import common
    from sm3x_torch.train.backbone_train import SSLTrainer

    batch = MAIN_BATCH
    data = synthetic_paired_data(FEED_CASES, canvas=320, seed=0)
    fields = ("derm", "derm_hw", "clinic", "clinic_hw")
    per_step = sum(getattr(next(data.batches(batch)), f).nbytes
                   for f in fields)
    log(f"[feed] [main]'s recipe (resnet50/v32, batch {batch}, bf16 autocast, "
        f"224x224) over {FEED_CASES} synthetic cases, {FEED_STEPS} steps "
        f"under each --device-feed from the same seed and initial weights; "
        f"a batch's canvases and sizes are {per_step / 1e6:.1f} MB")

    def prefetch_threads():
        return [t for t in threading.enumerate()
                if t.name == "sm3x-torch-prefetch" and t.is_alive()]

    # the losses can only be compared bit for bit where the arithmetic is
    # repeatable: cuDNN is held to its deterministic algorithms for the
    # three runs (the step times below are taken under that setting)
    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    log("  cuDNN held to deterministic algorithms for this phase")
    counters, _ = kernel_counters()
    out, losses, trainer = {}, {}, None
    for feed in FEEDS:
        del trainer
        torch.cuda.empty_cache()
        cfg = stage1_cfg(f"feed_{feed}", "resnet50", batch)
        cfg.data.device_feed = feed
        trainer = SSLTrainer(cfg)
        seed = cfg.run.seed
        wrapped = wrap_from_config(data, trainer.device, cfg.data)
        kind = {"host": type(data), "resident": DeviceData,
                "prefetch": PrefetchData}[feed]
        if type(wrapped) is not kind:
            raise AssertionError(f"--device-feed {feed} gave "
                                 f"{type(wrapped).__name__}")

        # the batches, bit for bit against the host data's
        it = wrapped.batches(batch, 0, seed)
        for k, want in zip(range(FEED_STEPS), data.batches(batch, 0, seed)):
            got = next(it)
            for f in fields:
                a = to_device(getattr(got, f), "cuda")
                b = torch.from_numpy(getattr(want, f)).cuda()
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(f"{feed}: step {k}, {f} differs")
            if not (np.array_equal(got.index, want.index)
                    and np.array_equal(got.label, want.label)
                    and np.array_equal(got.mask, want.mask)):
                raise AssertionError(f"{feed}: step {k}, index differs")
        it.close()   # an early break out of the epoch
        if prefetch_threads():
            raise AssertionError("an early break left a prefetch thread")

        # the steps: from asking for the batch to the end of the step
        reset_counters()
        it = wrapped.batches(batch, 0, seed)
        times, step_losses = [], []
        for k in range(FEED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = next(it)
            metrics = trainer.train_step(
                *(trainer._upload(getattr(b, f)) for f in fields),
                prng.step_seed(seed, 0, k))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            step_losses.append(float(metrics["loss"]))
        launches = {fn.__name__: fn.launches for fn in counters}
        k1 = dict(K.photometric_cuda.variants)
        want = {fn.__name__: MAIN_PER_STEP.get(fn.__name__, 0) * FEED_STEPS
                for fn in counters}
        if launches != want or k1 != {"band": 4 * FEED_STEPS, "scratch": 0}:
            raise AssertionError(f"{feed}: launches {launches}, K1 {k1}, "
                                 f"expected {want}, all band")
        if not all(math.isfinite(x) for x in step_losses):
            raise AssertionError(f"{feed}: losses {step_losses}")
        # the device's busy share over three more steps of the same epoch
        res = profile_device(
            lambda k: trainer.train_step(
                *(trainer._upload(getattr(b, f))
                  for b in [next(it)] for f in fields),
                prng.step_seed(seed, 0, FEED_STEPS + k)), 3)
        it.close()
        if prefetch_threads():
            raise AssertionError("an early break left a prefetch thread")
        losses[feed] = step_losses
        out[feed] = dict(step_ms=statistics.median(times),
                         step_ms_min=min(times), busy_ms=res["busy_ms"],
                         busy_share=res["busy_ms"] / res["wall_ms"],
                         launches=launches)
        log(f"  --device-feed {feed} ({type(wrapped).__name__}): batches "
            f"bit-identical to the host data's; losses {step_losses}")
        log(f"    step, batch fetch included: median {out[feed]['step_ms']:.1f}"
            f" ms, min {min(times):.1f} over {FEED_STEPS} steps (host clock, "
            f"synchronised); device busy {res['busy_ms']:.1f} ms a step of "
            f"{res['wall_ms']:.1f} ms ({100 * out[feed]['busy_share']:.1f}% "
            f"busy, torch.profiler, 3 steps); K1 launches {launches['photometric_cuda']}"
            f" ({k1}), K2f {launches['ntxent_forward_cuda']}, K2b "
            f"{launches['ntxent_backward_cuda']}")
        if feed == "resident":
            pinned = resident_nbytes(wrapped)
            log(f"    the resident feed pins {pinned} bytes "
                f"({pinned / 1e6:.0f} MB) of the "
                f"{cfg.data.hbm_data_budget_mb} MB budget")
            if pinned != FEED_CASES * 2 * 320 * 320 * 3:
                raise AssertionError("resident bytes are not the canvases'")
        del wrapped, it
    for feed in FEEDS[1:]:
        if losses[feed] != losses["host"]:
            raise AssertionError(f"losses under {feed} differ from host's: "
                                 f"{losses[feed]} vs {losses['host']}")
    log(f"  losses equal bit for bit under {', '.join(FEEDS)}: True")
    torch.backends.cudnn.deterministic = was_deterministic

    # what the upload costs under `host`: the four arrays of a batch from
    # pageable memory, as the trainer uploads them
    uploads = []
    for _, b in zip(range(FEED_STEPS), data.batches(batch, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        held = [trainer._upload(getattr(b, f)) for f in fields]
        torch.cuda.synchronize()
        uploads.append((time.perf_counter() - t0) * 1e3)
    del held
    out["host"]["upload_ms"] = statistics.median(uploads)
    log(f"  the upload under host: median {statistics.median(uploads):.2f} "
        f"ms, min {min(uploads):.2f} a batch of {per_step / 1e6:.1f} MB from "
        f"pageable memory ({per_step / 1e6 / statistics.median(uploads):.1f} "
        f"GB/s); slicing the batch on the host is in the step times above, "
        f"not here")

    # what `auto` picks
    auto = wrap_from_config(data, trainer.device, DataConfig())
    small = wrap_from_config(data, trainer.device,
                             DataConfig(hbm_data_budget_mb=256))
    log(f"  --device-feed auto: {type(auto).__name__} under the default "
        f"budget, {type(small).__name__} under --hbm-data-budget-mb 256")
    if type(auto) is not DeviceData or type(small) is not PrefetchData:
        raise AssertionError("auto must take resident when the canvases fit "
                             "the budget, else prefetch")
    del auto, small

    # one save_async of the full stage-1 state against a synchronous save
    log_path = trainer.cfg.run.log_path
    os.makedirs(log_path, exist_ok=True)
    sync_path = os.path.join(log_path, "sync.pth")
    async_path = os.path.join(log_path, "async.pth")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save(sync_path, 0)
    sync_ms = (time.perf_counter() - t0) * 1e3
    want = common.map_tensors(lambda t: t.detach().cpu().clone(),
                              trainer.live_state(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_async(async_path, 0)
    held_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    held_sync_ms = (time.perf_counter() - t0) * 1e3
    it = data.batches(batch, 2)
    for k in range(2):   # the live weights move on while the file is written
        b = next(it)
        trainer.train_step(*(trainer._upload(getattr(b, f)) for f in fields),
                           prng.step_seed(0, 2, k))
    t0 = time.perf_counter()
    trainer.finish_checkpoints()
    wait_ms = (time.perf_counter() - t0) * 1e3
    from sm3x_torch.utils.checkpoint import load_checkpoint_file

    def flat(tree):
        leaves = []
        common.map_tensors(leaves.append, tree)
        return leaves

    got = flat(load_checkpoint_file(async_path))
    snap, sync_file = flat(want), flat(load_checkpoint_file(sync_path))
    live = flat(common.map_tensors(lambda t: t.detach().cpu(),
                                   trainer.live_state(0)))
    equal = len(got) == len(snap) and all(
        torch.equal(a, b) for a, b in zip(got, snap))
    as_sync = len(got) == len(sync_file) and all(
        torch.equal(a, b) for a, b in zip(got, sync_file))
    moved = sum(not torch.equal(a, b) for a, b in zip(got, live))
    size = os.path.getsize(async_path)
    log(f"  save_async of the full stage-1 state ({size / 1e6:.0f} MB file, "
        f"{len(got)} tensors): the loop is held {held_ms:.1f} ms on the host "
        f"clock ({held_sync_ms:.1f} ms until the device has made the "
        f"clones) against {sync_ms:.1f} ms of a synchronous save; the "
        f"write then ran beside 2 steps, finish_checkpoints waited "
        f"{wait_ms:.1f} ms")
    log(f"  the file equals the state at the snapshot {equal} and the "
        f"synchronous save's file {as_sync}; {moved} of its tensors differ "
        f"from the live state two steps later")
    if not (equal and as_sync and moved > 0):
        raise AssertionError("the asynchronous save must write the snapshot")
    out["save"] = dict(held_ms=held_ms, held_synchronised_ms=held_sync_ms,
                       sync_ms=sync_ms, file_mb=size / 1e6)
    del trainer
    torch.cuda.empty_cache()
    out["streaming"] = feed_streaming()
    return out


def feed_streaming():
    """Streaming and the libjpeg loader on JPEGs written here, where an
    encoder is present: streamed batches through the prefetch feed against
    the cached ones, bit for bit."""
    from sm3x_torch.data.pipeline import PairedImageData
    from sm3x_torch.data.prefetch import PrefetchData, wrap_for_device
    from sm3x_torch.data.streaming import StreamingPairedData
    from sm3x_torch.native.loader import native_loader_available

    decoder = image_decoder()
    native = native_loader_available()
    try:
        import cv2  # noqa: F401  the decode path of what the loader leaves
        opencv = True
    except ImportError:
        opencv = False
    log(f"  streaming: image encoder {decoder or 'neither PIL nor cv2'}; the "
        f"libjpeg loader builds here (g++ and libjpeg's headers): {native}; "
        f"OpenCV to decode what it does not take: {opencv}")
    if decoder is None:
        log("  streaming and the native loader: not run here (no encoder to "
            "write the JPEGs); the CPU tests hold them "
            "(tests/test_torch_streaming.py)")
        return None
    if not (native or opencv):
        log("  streaming: not run here (no libjpeg loader and no OpenCV to "
            "decode with)")
        return None
    n, root = 48, os.path.join(LOGS, "feed_jpegs")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(7)
    paths = {"derm": [], "clinic": []}
    for kind in paths:
        for i in range(n):
            # smooth images: noise would not survive a JPEG
            small = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
            img = np.kron(small, np.ones((60, 60, 1), np.uint8))  # 360 x 480
            p = os.path.join(root, f"{kind}{i:03d}.jpg")
            with open(p, "wb") as f:
                f.write(encode_image(img, "JPEG", decoder))
            paths[kind].append(p)
    labels = rng.integers(0, 2, (n, 8)).astype(np.int32)
    t0 = time.perf_counter()
    cached = PairedImageData(paths["derm"], paths["clinic"], labels)
    decode_s = time.perf_counter() - t0
    stream = StreamingPairedData(paths["derm"], paths["clinic"], labels)
    wrapped = wrap_for_device(stream, torch.device("cuda"))
    if type(wrapped) is not PrefetchData:
        raise AssertionError("a streaming dataset goes with the prefetch feed")
    steps = 0
    for got, want in zip(wrapped.batches(16, 1), cached.batches(16, 1)):
        for f in ("derm", "derm_hw", "clinic", "clinic_hw"):
            if not torch.equal(getattr(got, f).cpu(),
                               torch.from_numpy(getattr(want, f))):
                raise AssertionError(f"streamed {f} differs at step {steps}")
        if not np.array_equal(got.index, want.index):
            raise AssertionError("streamed index differs")
        steps += 1
    hw = tuple(int(x) for x in cached.derm.valid_hw[0])
    scale = min(320 / 310, 320 / 430)   # 360 x 480 less the 25-pixel border
    want_hw = (round(310 * scale), round(430 * scale))
    log(f"  {2 * n} JPEGs of 360x480 decoded into canvas 320 in "
        f"{decode_s * 1e3:.0f} ms (valid size {hw} after the crop and "
        f"the area resize); {steps} streamed batches of 16 through the "
        f"prefetch feed bit-identical to the cached ones")
    if steps != 3 or hw != want_hw:
        raise AssertionError(f"streaming: 3 batches of valid size {want_hw}")
    return dict(native=native, decode_ms=decode_s * 1e3)


# [prefetch]: tools/bench_prefetch_torch.py at the JAX tool's defaults (160
# cases, batch 32, 4 epochs, resnet50): 80 train cases, 3 steps an epoch
PREFETCH_FEEDS = ("sync", "prefetch", "resident", "stream")
PREFETCH_STEPS = 4 * 3
PREFETCH_LINE = re.compile(r"^\[(\w+)\] (\d+) epochs of (\d+) steps, timed "
                           r"seconds \[.*\], kernel launches (\{.*\})$")


def phase_prefetch() -> dict:
    """The feed benchmark in a process of its own, as a user runs it: four
    JSON lines with the JAX tool's metrics, each rate above 0, and each
    feed's launches from the tool's standard error (K1 4, K2f and K2b 1 a
    step, no other kernel); its working directory left empty. Returns
    {feed: {counter: launches}}."""
    work = os.path.join(LOGS, "prefetch")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    log("[prefetch] tools/bench_prefetch_torch.py at its defaults (160 "
        "cases, batch 32, 4 epochs, resnet50)")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "bench_prefetch_torch.py")],
        cwd=work, capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines() + res.stderr.splitlines()[-20:]:
        log(f"  {line}")
    if res.returncode != 0:
        raise AssertionError(f"bench_prefetch_torch.py exited {res.returncode}")
    lines = [json.loads(line) for line in res.stdout.splitlines()]
    if [line.get("metric") for line in lines] != [
            f"ssl_feed_{f}_images_per_sec" for f in PREFETCH_FEEDS]:
        raise AssertionError("bench_prefetch_torch.py did not print the four "
                             "feeds' lines")
    if not all(line["value"] > 0 for line in lines):
        raise AssertionError("a feed's rate is not above 0")
    if os.listdir(work):
        raise AssertionError(f"the tool left {os.listdir(work)} behind")
    counters, _ = kernel_counters()
    launches = {}
    for match in map(PREFETCH_LINE.match, res.stderr.splitlines()):
        if match:
            epochs, steps = int(match[2]), int(match[3])
            launches[match[1]] = json.loads(match[4])
            if epochs * steps != PREFETCH_STEPS:
                raise AssertionError(f"{match[1]}: {epochs} x {steps} steps")
    want = {fn.__name__: MAIN_PER_STEP.get(fn.__name__, 0) * PREFETCH_STEPS
            for fn in counters}
    for feed in PREFETCH_FEEDS:
        if launches.get(feed) != want:
            raise AssertionError(f"{feed}: launches {launches.get(feed)}, "
                                 f"want {want}")
    log(f"  kernel launches a feed as expected: {want}")
    shutil.rmtree(work)
    return launches


# [dist]: the stage-1 step at [main]'s recipe under torch.distributed
DIST_STEPS = 3
# the distributed run against the plain one-process trainer, a loss limit
# relative a step. float32 (TF32 off): measured <= 1.7e-5 on an H100. bf16:
# the global-batch BatchNorm's kernels round otherwise than F.batch_norm's,
# and bf16 carries that through the network: the swap alone, in one
# process, moves the losses by 1.8e-3, 9.2e-3 and 5.1e-3 at these batches
# (float32: 1e-6 to 1.7e-5), so the limit sits above that and below what
# a BatchNorm normalising with half the batch's statistics reads
# (tools/dist_controls_torch.py)
DIST_LOSS_RTOL = {"float32": 1e-4, "bf16": 1.5e-2}
# the update against the plain trainer's: the share of parameters more
# than 0.1 x lr apart. Adam's first step is about lr x sign(g) an entry,
# so a wrong gradient moves tens of percent of them by ~2 lr; rounding
# moves 0.5% after one float32 step and 8.2% after three (H100). In bf16
# rounding alone moves 88%, so only the loss holds bf16
DIST_SHARE_MAX = {1: 0.02, DIST_STEPS: 0.2}
BN_SHAPE = (96, 256, 56, 56)   # a ResNet-50 layer1 output at batch 96
# the global-batch BatchNorm at world size 2 against F.batch_norm on the
# whole batch: relative Frobenius error of y, dx, the ranks' summed dw and
# db, and the running statistics. float32: summation order only (the
# gradient's parts along 1 and x cancel, which magnifies it); bf16
# against float32 arithmetic on the same bf16 inputs: bf16's rounding of y
# and dx (2^-9 relative an entry)
BN_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def params_diff(a, b, far: float):
    """(max abs difference, share of entries beyond `far`) of two models'
    parameters."""
    worst, beyond, total = 0.0, 0, 0
    for p, q in zip(a.parameters(), b.parameters()):
        d = (p.detach().float() - q.detach().float()).abs()
        worst = max(worst, float(d.max()))
        beyond += int((d > far).sum())
        total += d.numel()
    return worst, beyond / total


def state_digest(module) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in module.state_dict().values():
        h.update(t.detach().contiguous().view(-1).cpu().numpy().view(
            np.uint8).data)
    return h.hexdigest()


@contextlib.contextmanager
def plain_batch_norm():
    """Under a process group: the port's BatchNorm as it runs without one
    (K6 on the card), for the plain trainer's steps timed in turns with the
    distributed trainer's."""
    from sm3x_torch.models import layers

    real = layers.is_distributed
    layers.is_distributed = lambda: False
    try:
        yield
    finally:
        layers.is_distributed = real


def bn_ms() -> float:
    """Forward and backward of the port's BatchNorm(256) in train mode on
    BN_SHAPE, bf16 channels_last, the kernels alone (torch.profiler, 20
    calls): K6 without a process group, the global-batch path under
    one."""
    from sm3x_torch.models.layers import BatchNorm

    bn = BatchNorm(BN_SHAPE[1]).cuda().train()
    x = torch.randn(BN_SHAPE, device="cuda", dtype=torch.bfloat16).to(
        memory_format=torch.channels_last).requires_grad_(True)
    g = torch.randn_like(x)

    def call():
        x.grad = None
        bn(x).backward(g)

    return kernel_ms(call, reps=20)


def all_reduce_bytes(fn):
    """(fn's result, bytes and calls through torch.distributed.all_reduce
    while it ran): the BatchNorm backward's sums and the reported loss;
    DDP's gradient buckets go through its reducer and are counted apart."""
    import torch.distributed as dist

    real, seen = dist.all_reduce, [0, 0]

    def counting(t, *a, **k):
        seen[0] += t.numel() * t.element_size()
        seen[1] += 1
        return real(t, *a, **k)

    dist.all_reduce = counting
    try:
        out = fn()
    finally:
        dist.all_reduce = real
    return out, seen[0], seen[1]


def dist_check(tag: str, ref, ref_losses, trainer, losses, arith: str,
               say=log) -> bool:
    """Losses and parameters of a distributed run against a one-process
    run from the same initial weights and batches; True where they hold:
    each loss within DIST_LOSS_RTOL, and in float32 the share of entries
    more than 0.1 x lr apart within DIST_SHARE_MAX."""
    lr = trainer.cfg.optim.base_lr
    rtol = DIST_LOSS_RTOL[arith]
    ok = len(losses) == len(ref_losses)
    for i, (a, b) in enumerate(zip(losses, ref_losses)):
        rel = abs(a - b) / abs(b)
        say(f"  {tag} step {i}: loss {a:.6f} against {b:.6f}, relative "
            f"{rel:.2e} (tolerance {rtol:g})")
        ok &= math.isfinite(a) and rel <= rtol
    worst, share = params_diff(trainer.model, ref.model, 0.1 * lr)
    # Adam's step is at most lr (1 - b1) / sqrt(1 - b2) = 3.17 lr an entry
    # whatever the gradient (Kingma and Ba, 2.1), so two runs from one start
    # differ by at most twice that a step, plus float32 rounding of
    # parameters up to 2 in magnitude
    tol = len(losses) * (2 * 3.17 * lr + 2.5e-7)
    share_max = DIST_SHARE_MAX[len(losses)] if arith == "float32" else None
    say(f"  {tag} parameters after {len(losses)} step(s): max abs diff "
        f"{worst:.3e} (tolerance {tol:.2e}), {100 * share:.3f}% of entries "
        f"beyond 0.1 x lr ("
        + (f"tolerance {100 * share_max:g}%)" if share_max else
           "not held in bf16)"))
    return ok and worst <= tol and (share_max is None or share <= share_max)


def bn_world_check(say) -> bool:
    """The port's BatchNorm in train mode on this rank's rows of a global
    batch, on the card, against F.batch_norm on the whole batch in float32:
    y and dx of the rank's rows, dw and db summed over the ranks, the
    running statistics. (N, C, H, W) channels_last in float32 and bf16, and
    (N, C) as the projectors give it; a seeded batch with means and a
    gradient that has a part along x, so that each of the global sums
    matters. True where every error is within BN_RTOL."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from sm3x_torch.models.layers import EPS, MOMENTUM, BatchNorm
    from sm3x_torch.parallel import process_info

    rank, world = process_info()
    ok = True
    cases = ((torch.float32, BN_SHAPE), (torch.bfloat16, BN_SHAPE),
             (torch.float32, (2 * MAIN_BATCH, 512)))
    for dtype, shape in cases:
        gen = torch.Generator(device="cuda").manual_seed(7)
        c = shape[1]
        cs = (1, c) + (1,) * (len(shape) - 2)

        def draw(*size):
            return torch.randn(size, generator=gen, device="cuda")

        x = (draw(*shape) * (0.5 + draw(c).abs()).view(cs)
             + draw(c).view(cs) * 3)
        g = draw(*shape) + draw(c).view(cs) + 0.5 * x
        fmt = (torch.channels_last if len(shape) == 4
               else torch.contiguous_format)
        x = x.to(dtype).contiguous(memory_format=fmt)
        g = g.to(dtype).contiguous(memory_format=fmt)
        bn = BatchNorm(c).cuda().train()
        with torch.no_grad():
            bn.weight.copy_(1 + 0.5 * draw(c))
            bn.bias.copy_(draw(c))
            bn.running_mean.copy_(draw(c))
            bn.running_var.copy_(1 + draw(c).abs())
        w0, b0 = bn.weight.detach().clone(), bn.bias.detach().clone()
        rm0, rv0 = bn.running_mean.clone(), bn.running_var.clone()
        rows = slice(rank * shape[0] // world, (rank + 1) * shape[0] // world)
        xr = x[rows].detach().clone(memory_format=fmt).requires_grad_(True)
        y = bn(xr)
        y.backward(g[rows])
        dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
        dist.all_reduce(dw)
        dist.all_reduce(db)
        # the reference: float32 arithmetic on the same inputs
        xf = x.float().requires_grad_(True)
        wf, bf = w0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        yf = F.batch_norm(xf, rm0.clone(), rv0.clone(), wf, bf, True,
                          MOMENTUM, EPS)
        yf.backward(g.float())
        dims = [0] + list(range(2, len(shape)))
        x64 = x.double()
        pairs = {
            "y": (y, yf[rows]), "dx": (xr.grad, xf.grad[rows]),
            "dw": (dw, wf.grad), "db": (db, bf.grad),
            "running_mean": (bn.running_mean, (1 - MOMENTUM) * rm0
                             + MOMENTUM * x64.mean(dims)),
            "running_var": (bn.running_var, (1 - MOMENTUM) * rv0
                            + MOMENTUM * x64.var(dims, unbiased=False))}
        errs = {k: float((a.detach().double() - b.detach().double()).norm()
                         / b.detach().double().norm())
                for k, (a, b) in pairs.items()}
        rtol = BN_RTOL[dtype]
        good = all(math.isfinite(e) and e <= rtol for e in errs.values())
        say(f"BatchNorm({c}) on {shape[0] // world} of {shape} rows, "
            f"{str(dtype).split('.')[-1]}, world {world}: relative error "
            + ", ".join(f"{k} {e:.1e}" for k, e in errs.items())
            + f" (tolerance {rtol:g}) {'ok' if good else 'OFF'}")
        ok &= good
        del x, g, xr, xf, y, yf
    torch.cuda.empty_cache()
    return ok


def drop_graph(trainer) -> None:
    """Puts a trainer whose step is a CUDA graph back on its eager step and
    frees the graph with its memory pool: the step's whole working memory,
    which the graph holds while it lives (~17 GB at [main]'s recipe in
    bf16, ~31 GB in float32). For a one-process run kept as a reference
    beside other trainers on the card."""
    from sm3x_torch.train.common import GraphedStep

    if isinstance(trainer.train_step, GraphedStep):
        trainer.train_step = trainer.train_step.eager
    gc.collect()
    torch.cuda.empty_cache()


def dist_cfg(tag: str, amp: bool):
    cfg = stage1_cfg(tag, "resnet50", MAIN_BATCH)
    cfg.optim.amp = amp
    return cfg


def phase_dist(profile_dir=None) -> dict:
    """[main]'s stage-1 recipe (resnet50, 224x224, v32, proj 128, global
    batch 96, --world-size 2) under torch.distributed, with cuDNN held to
    its deterministic algorithms. Leg A: a world-size-1 NCCL group through
    distributed_initialize; SSLTrainer.fit over 3 steps under DDP with the
    global-batch BatchNorm, every kernel count set to 0 just before, in
    bf16 autocast (the recipe) and in float32 (TF32 off), each against the
    plain trainer (one process, so its step is a CUDA graph; the DDP
    trainer's is eager). Then the bf16 step's time against the plain
    trainer's graph and its eager step, the device's busy time, the all-reduce bytes a step and one BatchNorm
    against F.batch_norm. Leg B: two processes on this one card over gloo
    with CUDA tensors, one float32 step each at 48 rows against the
    one-process step, and the global-batch BatchNorm at world size 2
    against F.batch_norm on the whole batch (bn_world_check). Leg C: the
    same over two NCCL ranks, where there are two cards."""
    from torch.nn.parallel import DistributedDataParallel

    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.parallel import collectives as C
    from sm3x_torch.parallel.launch import free_port, launch_local
    from sm3x_torch.train.backbone_train import SSLTrainer
    from sm3x_torch.train.common import GraphedStep

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    data = synthetic_paired_data(MAIN_BATCH * DIST_STEPS, canvas=320, seed=0)
    one = {}     # (arithmetic, BatchNorm) -> (trainer, losses)
    for arith, amp in (("bf16", True), ("float32", False)):
        tr = SSLTrainer(dist_cfg(f"dist_plain_{arith}", amp))
        one[arith, "plain"] = tr, tr.fit(data)[0]["step_losses"]
    # only the float32 run's weights are read from here on
    drop_graph(one["float32", "plain"][0])
    bn_plain = bn_ms()
    C.distributed_initialize(f"127.0.0.1:{free_port()}", 1, 0,
                             backend="nccl")
    counters, _ = kernel_counters()
    ok = True
    try:
        log(f"[dist] leg A: world-size-1 NCCL group "
            f"({torch.distributed.get_backend()}), SSLTrainer.fit under DDP "
            f"with the global-batch BatchNorm, resnet50/v32, proj 128, "
            f"batch {MAIN_BATCH}, --world-size 2, 224x224, {DIST_STEPS} "
            f"steps through ProcessShardedData; cuDNN deterministic")
        ddp = {}
        for arith, amp in (("bf16", True), ("float32", False)):
            tr = SSLTrainer(dist_cfg(f"dist_ddp_{arith}", amp))
            if not isinstance(tr.net, DistributedDataParallel):
                raise AssertionError("the trainer is not under DDP")
            reset_counters()
            hist, nbytes, calls = all_reduce_bytes(lambda: tr.fit(data))
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counters}
            k1 = dict(K.photometric_cuda.variants)
            log(f"  {arith}: kernel launches in fit: {launches}; K1 by "
                f"kernel {k1}")
            want = {fn.__name__: SSL_PER_STEP.get(fn.__name__, 0) *
                    DIST_STEPS for fn in counters}
            if launches != want or k1["scratch"]:
                raise AssertionError(f"launch counts {launches}, expected "
                                     f"{want}")
            ddp[arith] = tr, hist[0]["step_losses"]
        for arith in ("bf16", "float32"):
            ok &= dist_check(f"leg A {arith} against the plain trainer",
                             *one[arith, "plain"], *ddp[arith], arith)
        if not ok:
            raise AssertionError("leg A: off the one-process run")
        grads = sum(p.numel() * p.element_size()
                    for p in ddp["bf16"][0].model.parameters()
                    if p.requires_grad)
        log(f"  all-reduce a step: DDP's gradient buckets {grads / 1e6:.1f} "
            f"MB; torch.distributed.all_reduce {nbytes / DIST_STEPS / 1e3:.1f}"
            f" kB in {calls / DIST_STEPS:.0f} calls (the BatchNorm backward's "
            f"sums; float32 fit)")

        batches = [[torch.from_numpy(x).cuda() for x in
                    (b.derm, b.derm_hw, b.clinic, b.clinic_hw)]
                   for b in data.batches(MAIN_BATCH, 1, 3407)]
        # the plain trainer's steps with the BatchNorm of no group. It ran
        # in one process, so its step is a CUDA graph; its eager step is
        # timed too, the like of the DDP step (a process group keeps the
        # step eager)
        plain = one["bf16", "plain"][0].train_step
        if not isinstance(plain, GraphedStep):
            raise AssertionError("the one-process trainer's step is eager")
        runs = {"plain_graph": (plain, plain_batch_norm),
                "plain_eager": (plain.eager, plain_batch_norm),
                "dist": (ddp["bf16"][0].train_step, contextlib.nullcontext)}
        times = {k: [] for k in runs}
        for _ in range(2):      # in turns, so that drift falls on each
            for k, (fn, mode) in runs.items():
                with mode():
                    times[k] += timed_steps([
                        lambda it=it, a=a, fn=fn: fn(*a, it)["loss"]
                        for it, a in enumerate(batches)])
        busy = {}
        for k, (fn, mode) in runs.items():
            step = lambda it, fn=fn: fn(*batches[it], it)
            with mode():
                busy[k] = (profile_steps(step, len(batches), profile_dir,
                                         f"profile_dist_{k}.txt")
                           if profile_dir else
                           profile_device(step, len(batches)))
        for k in runs:
            log(f"  {k} bf16 step: median "
                f"{statistics.median(times[k]) * 1e3:.1f} ms, min "
                f"{min(times[k]) * 1e3:.1f} over {len(times[k])} steps "
                f"(host clock, synchronised); device busy "
                f"{busy[k]['busy_ms']:.1f} ms a step of "
                f"{busy[k]['wall_ms']:.1f} "
                f"({100 * busy[k]['busy_ms'] / busy[k]['wall_ms']:.1f}%), "
                f"{busy[k]['launches']:.0f} kernels and copies")
        bn_global = bn_ms()
        log(f"  BatchNorm(256) forward + backward on {BN_SHAPE} bf16 "
            f"channels_last, the kernels alone: one process (K6) "
            f"{ms_or_not(bn_plain)}, global-batch {ms_or_not(bn_global)}")
    finally:
        C.shutdown()
        torch.backends.cudnn.deterministic = False
    # every name that holds a trainer or its steps: the plain trainer's
    # graph keeps its pool (~17 GB) while anything reaches it
    del one, ddp, runs, plain, fn, step, tr
    gc.collect()    # the trainers' reference cycles hold them too
    torch.cuda.empty_cache()

    def worker_results(res, leg) -> list:
        out = []
        for r, (rc, text) in enumerate(res):
            line = [ln for ln in text.splitlines()
                    if ln.startswith("DIST_WORKER ")]
            if rc != 0 or not line:
                raise AssertionError(f"{leg}: rank {r} exited {rc}:\n"
                                     + text[-4000:])
            out.append(json.loads(line[-1].split(" ", 1)[1]))
        for got in out:
            for ln in got["lines"]:
                log(f"  rank {got['rank']}: {ln}")
        if not all(got["ok"] for got in out):
            raise AssertionError(f"{leg}: off the one-process step")
        if len({got["digest"] for got in out}) != 1:
            raise AssertionError(f"{leg}: the ranks' states differ")
        log(f"  {leg}: both ranks' states identical bit for bit")
        return out

    env = dict(os.environ, PYTHONPATH=ROOT)

    def worker(backend: str, legs: str) -> list:
        return [sys.executable, os.path.abspath(__file__), "--dist-worker",
                backend, "--dist-legs", legs]

    t = time.perf_counter()
    log("[dist] leg B: two processes on this card over gloo with CUDA "
        f"tensors, one float32 step of the same recipe at "
        f"{MAIN_BATCH // 2} rows a rank against the one-process step; the "
        f"global-batch BatchNorm against F.batch_norm on the whole batch")
    worker_results(launch_local(worker("gloo", "main"), 2, 400, env=env,
                                cwd=ROOT), "leg B")
    log(f"  leg B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    log(f"[dist] leg D: two processes on this card over gloo with CUDA "
        f"tensors, bf16 autocast: [crop]'s recipe (resnet50, global batch "
        f"{MAIN_BATCH}) and [tri]'s (vit_b16 flash, global batch "
        f"{TRI_BATCH}), {DIST_RECIPES['crop'][-1]} steps each through fit, "
        f"against the one-process run of the same seed and views (rank 0 "
        f"runs it first)")
    legd = worker_results(launch_local(worker("gloo", "crop,tri"), 2, 900,
                                       env=env, cwd=ROOT), "leg D")
    log(f"  leg D: {time.perf_counter() - t:.1f} s")
    if torch.cuda.device_count() >= 2:
        log("[dist] leg C: two NCCL ranks, a card each")
        worker_results(launch_local(worker("nccl", "main"), 2, 400,
                                    env=env, cwd=ROOT), "leg C")
    else:
        log(f"[dist] leg C: needs two cards, this machine has "
            f"{torch.cuda.device_count()}; not run")
    log(f"  [dist] took {time.perf_counter() - t_phase:.1f} s")
    return launches, legd[0]["launches"]


# the recipes of [dist]'s two-rank legs: name -> (encoder, global batch,
# --use-checkpoint, recipe tweak, launches a step, bf16 autocast, steps).
# Legs B and C: [main]'s, one float32 step. Leg D: [crop]'s and [tri]'s,
# 2 steps each (3 in [crop] and [tri]: the collectives copy every gradient
# through the host, ~690 MB a step for two ViT-B/16)
DIST_RECIPES = {"main": ("resnet50", MAIN_BATCH, False, None, SSL_PER_STEP,
                         False, 1),
                "crop": ("resnet50", MAIN_BATCH, False, crop_tweak,
                         SSL_PER_STEP, True, 2),
                "tri": ("vit_b16", TRI_BATCH, "flash", tri_tweak,
                        VIT_PER_STEP, True, 2)}


def dist_worker(backend: str, legs: list) -> int:
    """A rank of [dist]'s leg B (gloo, both ranks on card 0), leg C (NCCL,
    a card each) or leg D (gloo), running the DIST_RECIPES named in `legs`:
    a one-process run of each first (every rank of [main]'s, rank 0 alone
    of the others); then both run it as the two ranks, every count set to
    0 just before fit, and a rank that made the one-process run holds its
    run against it (dist_check); after [main]'s recipe both ranks run
    bn_world_check. One DIST_WORKER line with the results, the
    launches of each run, its steps' times and the rank's peak memory."""
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.parallel import collectives as C
    from sm3x_torch.train.backbone_train import SSLTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rank = int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))

    def make(name: str, run: str):
        arch, batch, remat, tweak, _, amp, steps = DIST_RECIPES[name]
        data = synthetic_paired_data(batch * steps, canvas=320, seed=0)
        cfg = stage1_cfg(f"dist_{name}_{backend}_{run}_r{rank}", arch, batch,
                         remat)
        cfg.optim.amp = amp
        if tweak is not None:
            tweak(cfg, data)
        return SSLTrainer(cfg), data

    one = {}
    for name in legs:
        # rank 1 waits in distributed_initialize while rank 0 runs leg D's:
        # a ViT-B/16 pair's checkpoint is 2 GiB of the machine's 45 GiB of
        # disk writes a call
        if rank == 0 or name == "main":
            tr, data = make(name, "one")
            one[name] = tr, tr.fit(data)[0]["step_losses"]
    C.distributed_initialize(backend=backend)
    counters, _ = kernel_counters()
    lines, ok, digests, launches = [], True, [], {}
    for name in legs:
        arch, batch, _, _, per_step, amp, steps = DIST_RECIPES[name]
        trainer, data = make(name, "two")
        step = trainer.train_step
        times = []

        def timed_step(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        trainer.train_step = timed_step
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        hist = trainer.fit(data)
        torch.cuda.synchronize()
        launches[name] = {fn.__name__: fn.launches for fn in counters}
        want = {fn.__name__: per_step.get(fn.__name__, 0) * steps
                for fn in counters}
        ok &= launches[name] == want
        lines.append(
            f"{name} ({arch}, global batch {batch}, {batch // 2} rows a "
            f"rank, {'bf16' if amp else 'float32'}): kernel launches in fit "
            f"{launches[name]} (expected {want}); steps "
            f"{[round(t, 1) for t in times]} ms (host clock, synchronised; "
            f"the first with its warm-ups); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on this "
            f"rank")
        if name in one:
            ok &= dist_check(f"{name} rank {rank} against one process",
                             *one.pop(name), trainer,
                             hist[0]["step_losses"],
                             "bf16" if amp else "float32", say=lines.append)
        digests.append(state_digest(trainer.model))
        del trainer
        torch.cuda.empty_cache()
        if name == "main":
            ok &= bn_world_check(lines.append)
    print("DIST_WORKER " + json.dumps({
        "rank": rank, "lines": lines, "ok": bool(ok),
        "digest": "".join(digests), "launches": launches}), flush=True)
    C.shutdown()
    return 0


# [tp]: tensor parallelism, two gloo ranks on this one card (data 1 x model
# 2). vit_b16 stage 1 at a global batch of 32 through fit, bf16 autocast
# and --use-checkpoint flash, so that K3 runs at the 6 heads a rank holds
TP_MODEL, TP_BATCH, TP_STEPS = 2, 32, 2
TP_K3_SHAPE = (TP_BATCH, 197, 12 // TP_MODEL, 64)
TP_PER_STEP = dict(VIT_PER_STEP)
TP_STAGE2_BATCH = 64


def tp_cfg(tag: str, amp: bool, model: int, log_dir: str):
    """[vit]'s stage-1 recipe at a global batch of TP_BATCH under
    --mesh-model `model`, logging into `log_dir` (left as it is)."""
    cfg = stage1_cfg(tag, "vit_b16", TP_BATCH, "flash")
    cfg.optim.amp = amp
    cfg.run.mesh_model, cfg.run.log_path = model, log_dir
    return cfg


def tp_stage2_cfg(model: int, log_dir: str):
    """[stage2]'s recipe (resnet50 frozen, v4 / 512, 1 head, ff 128,
    dropout 0.1, T 1, lr 1e-4, float32) at a batch of TP_STAGE2_BATCH
    under --mesh-model `model`: 8 label heads, 4 a rank at model 2."""
    from sm3x_torch.core.config import MLCTrainConfig

    cfg = MLCTrainConfig()
    m, o, r = cfg.model, cfg.optim, cfg.run
    m.arch, m.mlc_proj, m.mlc_proj_dim, m.num_heads = "resnet50", "v4", 512, 1
    m.sa_dim_ff, m.sa_dropout, m.temperature = 128, 0.1, 1.0
    o.batch_size, o.base_lr, o.amp, o.epochs = TP_STAGE2_BATCH, 1e-4, False, 1
    cfg.data.img_sz, cfg.data.mean, cfg.data.std = (224, 224), MEAN, STD
    r.device, r.print_freq, r.mesh_model, r.log_path = ("cuda", 10 ** 6,
                                                        model, log_dir)
    r.ckpt_freq = 100   # ckp_0.pth alone
    return cfg


def tp_stage2_step(trainer) -> float:
    """One stage-2 step with fixed targets (as tests/test_tp.py holds the
    JAX package's): seeded canvases, a zero bank, assignments of 0 / 1."""
    from sm3x_torch.data.synthetic import synthetic_canvas_batch

    d, dh, _ = synthetic_canvas_batch(TP_STAGE2_BATCH, 320, 21)
    c, ch, _ = synthetic_canvas_batch(TP_STAGE2_BATCH, 320, 22)
    rows, dev = trainer.rows, trainer.device
    up = [rows.take(torch.from_numpy(x)).to(dev) for x in (d, dh, c, ch)]
    gen = np.random.default_rng(23)
    assign = torch.from_numpy(gen.integers(
        0, 2, (8, TP_STAGE2_BATCH))).to(dev)
    bank = torch.zeros(8, TP_STAGE2_BATCH, 512, device=dev)
    index = torch.arange(TP_STAGE2_BATCH, device=dev)
    return float(trainer.train_step(bank, *up, index, assign, 24))


def tp_dirs() -> dict:
    return {k: os.path.join(LOGS, f"tp_{k}")
            for k in ("one_bf16", "one_f32", "one_stage2", "two_bf16",
                      "two_f32", "two_stage2")}


def phase_tp() -> dict:
    """Tensor parallelism on this card: first the one-process runs (vit_b16
    stage 1 through fit, 2 bf16 steps and 1 float32 step; one stage-2 step
    of resnet50 with v4 / 512 heads), then K3 at the per-rank shape
    (32, 197, 6, 64) in bf16 against its plain version, then two processes
    over gloo on a grid of data 1 x model 2 (tp_worker) that run the same:
    every kernel count set to 0 just before the bf16 fit and read just
    after, the losses against the one-process run within [dist]'s limits,
    rank 0's whole ckp_0.pth loaded strictly by a one-process model and
    held against the one-process weights, the float32 step and the stage-2
    step the same way. NCCL across two cards where there are two."""
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.models.mlc import MLCModel
    from sm3x_torch.models.simclr import build_ssl_model
    from sm3x_torch.parallel.launch import launch_local
    from sm3x_torch.train.backbone_train import SSLTrainer
    from sm3x_torch.train.mlc_train import MLCTrainer

    t_phase = time.perf_counter()
    dirs = tp_dirs()
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    log(f"[tp] tensor parallelism (--mesh-model {TP_MODEL}): vit_b16/v32, "
        f"proj 128, T 0.1, global batch {TP_BATCH}, --world-size 2, "
        f"224x224, --use-checkpoint flash; the one-process runs first")
    one = {}
    for arith, amp, steps in (("bf16", True, TP_STEPS), ("f32", False, 1)):
        tr = SSLTrainer(tp_cfg(f"tp_one_{arith}", amp, 1,
                               dirs[f"one_{arith}"]))
        data = synthetic_paired_data(TP_BATCH * steps, canvas=320, seed=0)
        losses = tr.fit(data)[0]["step_losses"]
        one[arith] = tr.model.cpu(), losses
        log(f"  one process, {arith}: losses {losses}")
        drop_graph(tr)
        del tr
    tr = MLCTrainer(tp_stage2_cfg(1, dirs["one_stage2"]))
    loss = tp_stage2_step(tr)
    one["stage2"] = tr.model.cpu(), [loss]
    log(f"  one process, stage 2 (resnet50, v4 / 512, batch "
        f"{TP_STAGE2_BATCH}): loss {one['stage2'][1][0]:.6f}")
    del tr
    torch.cuda.empty_cache()

    k3 = k3_at_path_shape(TP_K3_SHAPE, (torch.bfloat16,),
                          f"tp (ViT-B/16, model {TP_MODEL})", "tp",
                          f"vit_b16's 12 heads over a model axis of "
                          f"{TP_MODEL}, a global batch of {TP_BATCH}",
                          np.random.default_rng(31))

    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, os.path.abspath(__file__), "--tp-worker", "gloo"]
    t = time.perf_counter()
    log(f"[tp] two processes on this card over gloo with CUDA tensors, a "
        f"grid of data 1 x model {TP_MODEL}")
    res = launch_local(cmd, TP_MODEL, 600, env=env, cwd=ROOT)
    got = []
    for r, (rc, text) in enumerate(res):
        line = [ln for ln in text.splitlines() if ln.startswith("TP_WORKER ")]
        if rc != 0 or not line:
            raise AssertionError(f"[tp]: rank {r} exited {rc}:\n"
                                 + text[-4000:])
        got.append(json.loads(line[-1].split(" ", 1)[1]))
    ok = True
    for g in got:
        log(f"  rank {g['rank']}: grid {g['grid']}; q weight "
            f"{g['q_shape']}, its AdamW moments {g['q_moment_shape']}; "
            f"kernel launches in fit {g['launches']}; K1 by kernel "
            f"{g['k1']}; K3 by kernel {g['k3']}; fit {g['fit_s']:.1f} s")
        want = {k: TP_PER_STEP.get(k, 0) * TP_STEPS for k in g["launches"]}
        if g["launches"] != want:
            raise AssertionError(f"[tp] launch counts {g['launches']}, "
                                 f"expected {want}")
        if g["k1"]["scratch"] or any(v["fma"] for v in g["k3"].values()):
            raise AssertionError("[tp]: a K1 scratch or K3 fma launch")
        if g["q_shape"] != [768 // TP_MODEL, 768] or \
                g["q_moment_shape"] != g["q_shape"]:
            raise AssertionError("[tp]: the q weight is not a rank's slice")
        for arith, key in (("bf16", "losses_bf16"), ("float32", "losses_f32"),
                           ("float32", "losses_stage2")):
            ref = one[{"losses_bf16": "bf16", "losses_f32": "f32",
                       "losses_stage2": "stage2"}[key]][1]
            for i, (a, b) in enumerate(zip(g[key], ref)):
                rel = abs(a - b) / abs(b)
                log(f"  rank {g['rank']} {key[7:]} step {i}: loss {a:.6f} "
                    f"against {b:.6f}, relative {rel:.2e} (tolerance "
                    f"{DIST_LOSS_RTOL[arith]:g})")
                ok &= math.isfinite(a) and rel <= DIST_LOSS_RTOL[arith]
    if len({g["replicated"] for g in got}) != 1:
        raise AssertionError("[tp]: replicated weights differ between ranks")
    log("  replicated weights identical bit for bit on both ranks")

    def whole(path, model):
        state = torch.load(path, map_location="cpu", weights_only=False)
        model.load_state_dict(state["state_dict"], strict=True)
        return model

    for name, path, ref, lr, share_max in (
            ("bf16 ckp_0.pth", os.path.join(dirs["two_bf16"], "ckp_0.pth"),
             "bf16", 1e-6, None),
            ("float32 ckp_0.pth", os.path.join(dirs["two_f32"], "ckp_0.pth"),
             "f32", 1e-6, DIST_SHARE_MAX[1]),
            ("stage-2 ckp_0.pth", os.path.join(dirs["two_stage2"],
                                               "ckp_0.pth"),
             "stage2", 1e-4, DIST_SHARE_MAX[1])):
        ref_model, ref_losses = one[ref]
        fresh = (MLCModel("resnet50", proj_dim=512, mlc_proj="v4",
                          sa_dim_ff=128, sa_dropout=0.1, img_size=224)
                 if ref == "stage2" else
                 build_ssl_model("v32", "vit_b16", 128, img_size=224)[0])
        loaded = whole(path, fresh)
        worst, share = params_diff(loaded, ref_model, 0.1 * lr)
        tol = len(ref_losses) * (2 * 3.17 * lr + 2.5e-7)
        good = worst <= tol and (share_max is None or share <= share_max)
        log(f"  rank 0's {name}, loaded strictly by a one-process model: "
            f"max abs diff {worst:.3e} from the one-process run (tolerance "
            f"{tol:.2e}), {100 * share:.3f}% of entries beyond 0.1 x lr ("
            + (f"tolerance {100 * share_max:g}%)" if share_max else
               "not held in bf16)") + f" {'ok' if good else 'OFF'}")
        ok &= good
    if not ok:
        raise AssertionError("[tp]: off the one-process run")
    log(f"  two processes: {time.perf_counter() - t:.1f} s")
    if torch.cuda.device_count() >= 2:
        log("[tp] two NCCL ranks, a card each")
        res = launch_local(cmd[:-1] + ["nccl"], TP_MODEL, 600, env=env,
                           cwd=ROOT)
        if any(rc != 0 for rc, _ in res):
            raise AssertionError("[tp] over NCCL: " + res[0][1][-4000:])
    else:
        log(f"[tp] NCCL tensor parallelism across cards needs two cards, "
            f"this machine has {torch.cuda.device_count()}; not run")
    log(f"  [tp] took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": got[0]["launches"], "k3": k3}


def tp_worker(backend: str) -> int:
    """A rank of [tp] (gloo: both ranks on card 0; NCCL: a card each) on a
    grid of data 1 x model TP_MODEL: the bf16 fit of vit_b16 with every
    kernel count set to 0 just before and read just after, the float32
    step through fit, the stage-2 step (rank 0 writes each run's whole
    ckp_0.pth); one TP_WORKER line with what it saw."""
    import hashlib

    from sm3x_torch.core.mesh import current_mesh
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.parallel import collectives as C
    from sm3x_torch.train.backbone_train import SSLTrainer
    from sm3x_torch.train.mlc_train import MLCTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    C.distributed_initialize(backend=backend)
    dirs = tp_dirs()
    out = {"rank": rank}
    counters, k3 = kernel_counters()

    tr = SSLTrainer(tp_cfg(f"tp_two_r{rank}", True, TP_MODEL,
                           dirs["two_bf16"]))
    mesh = current_mesh()
    out["grid"] = [mesh.data, mesh.model, mesh.data_index, mesh.model_index]
    data = synthetic_paired_data(TP_BATCH * TP_STEPS, canvas=320, seed=0)
    reset_counters()
    t = time.perf_counter()
    out["losses_bf16"] = tr.fit(data)[0]["step_losses"]
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t
    out["launches"] = {fn.__name__: fn.launches for fn in counters}
    out["k1"] = dict(K.photometric_cuda.variants)
    out["k3"] = {fn.__name__: dict(fn.variants) for fn in k3}
    q = tr.model.derm_backbone.encoder.block0.attn.query.weight
    out["q_shape"] = list(q.shape)
    out["q_moment_shape"] = list(tr.optimizer.state[q]["exp_avg"].shape)
    h = hashlib.sha256()
    for k, v in tr.model.state_dict().items():
        if tr.tp.plan(k, tr.tp.shapes[k], TP_MODEL) is None:
            h.update(v.detach().contiguous().view(-1).cpu().numpy().view(
                np.uint8).data)
    out["replicated"] = h.hexdigest()
    del tr
    torch.cuda.empty_cache()

    tr = SSLTrainer(tp_cfg(f"tp_two_r{rank}", False, TP_MODEL,
                           dirs["two_f32"]))
    out["losses_f32"] = tr.fit(synthetic_paired_data(
        TP_BATCH, canvas=320, seed=0))[0]["step_losses"]
    del tr
    torch.cuda.empty_cache()

    tr = MLCTrainer(tp_stage2_cfg(TP_MODEL, dirs["two_stage2"]))
    out["losses_stage2"] = [tp_stage2_step(tr)]
    tr.epoch_checkpoint(0)
    tr.finish_checkpoints()
    print("TP_WORKER " + json.dumps(out), flush=True)
    C.shutdown()
    return 0


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


def phase_vmoe() -> dict:
    """K5's four kernels at one routing group of the V-MoE-B/16 cell against
    their plain twins (sm3x_torch.ops.moe), bf16 then float32: dispatch,
    combine, dy and dx bitwise (the twins sum in the kernels' order), the
    gate gradient within float32 round-off of a 768-term dot product; each
    twice for identical bits; bf16 rows with their times and bounds."""
    from portbench.harness.kernels_moe import k5_bytes
    from sm3x_torch.ops import moe
    from sm3x_torch.ops import moe_cuda as K

    n, e, k, d = 64 * 197, 32, 2, 768
    cap = moe.capacity(n, k, e, 1.05)
    g = torch.Generator(device="cuda").manual_seed(5)
    gates, choices = torch.softmax(torch.randn(n, e, device="cuda",
                                               generator=g), -1).topk(k)
    smap = moe.slot_map(choices, e, cap)
    ts, sa = smap.token_slot, smap.slot_assign
    log(f"[vmoe] K5 at N {n}, E {e}, C {cap}, k {k}, D {d}: "
        f"{int(smap.dropped)} of {n * k} choices dropped; the slot map "
        f"{device_ms(lambda: moe.slot_map(choices, e, cap)):.4f} ms (50 "
        f"in a row)")
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, y, dout = (torch.randn(m, d, device="cuda", generator=g).to(dtype)
                      for m in (n, e * cap, n))
        kernels = {
            "dispatch_fwd": (lambda: K.moe_dispatch_cuda(x, sa, k),
                             lambda: moe.dispatch_plain(x, sa, k)),
            "combine_fwd": (lambda: K.moe_combine_cuda(y, gates, ts),
                            lambda: moe.combine_plain(y, gates, ts)),
            "combine_bwd": (lambda: K.moe_combine_backward_cuda(
                dout, y, gates, sa, k), lambda: moe.combine_backward_plain(
                    dout, y, gates, sa, ts)),
            "dispatch_bwd": (lambda: K.moe_dispatch_backward_cuda(y, ts),
                             lambda: moe.dispatch_backward_plain(y, ts)),
        }
        nbytes = k5_bytes(n, k, e, cap, d, n * k - int(smap.dropped))
        for name, (fn, plain) in kernels.items():
            got, again, want = fn(), fn(), plain()
            got, again, want = ((t,) if torch.is_tensor(t) else t
                                for t in (got, again, want))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"[vmoe] K5 {name} changed its bits")
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"[vmoe] K5 {name} is not its twin")
            if name == "combine_bwd":
                check_close(f"K5 {name} dgates {dtype}", got[1], want[1],
                            1e-5, 1e-4)
            if dtype != torch.bfloat16:
                continue
            row = dict(name=f"K5 {name}", shape=(n, e, cap, k, d),
                       dtype="bf16",
                       **bound(nbytes[name], 0, "bf16"))
            rows[name] = timed(row, fn, plain)
        log(f"[vmoe] K5 {dtype}: the four kernels equal their twins, twice "
            f"the same bits")
    log(json.dumps({"k5": rows}))
    return rows

# ResNet-50's batch norms in one forward pass at batch 96 and 224: (N H W,
# C) -> {(ReLU, residual): count}, 53 in all
R50_BN = {
    (96 * 112 * 112, 64): {(True, False): 1},
    (96 * 56 * 56, 64): {(True, False): 6},
    (96 * 56 * 56, 256): {(True, True): 3, (False, False): 1},
    (96 * 56 * 56, 128): {(True, False): 1},
    (96 * 28 * 28, 128): {(True, False): 7},
    (96 * 28 * 28, 512): {(True, True): 4, (False, False): 1},
    (96 * 28 * 28, 256): {(True, False): 1},
    (96 * 14 * 14, 256): {(True, False): 11},
    (96 * 14 * 14, 1024): {(True, True): 6, (False, False): 1},
    (96 * 14 * 14, 512): {(True, False): 1},
    (96 * 7 * 7, 512): {(True, False): 5},
    (96 * 7 * 7, 2048): {(True, True): 3, (False, False): 1},
}
# K6 against float64 arithmetic on the same inputs (the ReLU's mask from
# K6's y): y, dx and d_res within K6_TOL of their largest value (dx: of the
# largest gamma invstd dy', the terms it is a difference of), the running
# statistics, dgamma and dbeta within 1e-4 of theirs (tests/
# test_torch_batchnorm_act.py's limits); against its twin (torch's batch
# norm, add and ReLU, which round three times where K6 rounds once): the
# relative Frobenius error of y, and of dx and d_res where the two ReLU
# masks agree, within K6_REL, the masks apart on under 1% of the values
K6_TOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}
K6_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def rel_err(got, want, where=None) -> float:
    got, want = got.double(), want.double()
    if where is not None:
        got, want = got[where], want[where]
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


@torch.no_grad()
def k6_float64(x, res, dy, w, b, relu, y) -> dict:
    """float64 y, dx, d_res, dgamma, dbeta and one step's running
    statistics (from 0 and 1) of relu?(batch_norm(x) (+ res)), the mask of
    the ReLU taken from `y`; and the scale of dx's terms."""
    x64, dims = x.double(), (0, 2, 3)
    mean, var = x64.mean(dims), x64.var(dims, unbiased=False)
    invstd = 1 / torch.sqrt(var + 1e-5)
    ch = lambda t: t.double().view(1, -1, 1, 1)
    xhat = (x64 - ch(mean)) * ch(invstd)
    v = xhat * ch(w) + ch(b) + (0 if res is None else res.double())
    g = dy.double() * (y > 0) if relu else dy.double()
    n = x.numel() // x.shape[1]
    s1, s2 = g.sum(dims), (g * xhat).sum(dims)
    dx = ch(w * invstd) * (g - ch(s1 / n) - xhat * ch(s2 / n))
    return dict(y=v.clamp_min(0) if relu else v, dx=dx, dres=g, dw=s2,
                db=s1, rm=0.1 * mean, rv=0.9 + 0.1 * var,
                dx_scale=(ch(w * invstd) * g).abs().max().item())


def max_err(got, want, scale=0.0) -> float:
    """max |got - want| over the larger of max |want| and `scale`."""
    want = want.double()
    return ((got.double() - want).abs().max()
            / max(want.abs().max().item(), scale, 1e-30)).item()


def phase_bn() -> dict:
    """K6 (sm3x_torch/csrc/batchnorm.cu) at every batch norm of ResNet-50 at
    batch 96 and 224 (R50_BN), forward and backward through its autograd
    Function, against float64 and the plain twin in bf16 and float32
    (K6_TOL, K6_REL); in bf16,
    the path's type, the times of forward and backward together: the
    kernels alone (torch.profiler), 50 calls in a row, the twin's, and the
    one-library-call yardstick (F.batch_norm, + residual, relu: no
    running-variance correction; the port calls neither), beside the bytes
    bound (x, the residual and y of the forward, dy, x, y, dx and d_res of
    the backward, each once); then a ResNet-50 step's K6 time from the
    kernels alone."""
    import torch.nn.functional as F

    from sm3x_torch.ops import batchnorm_cuda as B

    g = torch.Generator(device="cuda").manual_seed(23)
    rows_out, per_step, per_step_bound = [], 0.0, 0.0
    for (rows, c), variants in R50_BN.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, res, dy = (torch.randn(96, rows // 96, 1, c, device="cuda",
                                      generator=g).to(dtype).permute(0, 3, 1, 2)
                          for _ in range(3))
            x = x * 2 + 0.5
            w = torch.rand(c, device="cuda", generator=g) + 0.5
            b = torch.randn(c, device="cuda", generator=g) * 0.3
            for (relu, residual), count in variants.items():
                r = res.clone().requires_grad_() if residual else None
                xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))
                leaves = [xl, wl, bl] + ([r] if residual else [])

                def moving():
                    return (torch.zeros(c, device="cuda"),
                            torch.ones(c, device="cuda"),
                            torch.zeros((), dtype=torch.long, device="cuda"))

                def run(fn, state):
                    y = fn(xl, wl, bl, *state, r, relu)
                    return (y,) + torch.autograd.grad(y, leaves, dy)

                kernel_state, twin_state = moving(), moving()
                got = run(B.batch_norm_act, kernel_state)
                twin = run(B.batch_norm_act_plain, twin_state)
                ref = k6_float64(x, r, dy, w, b, relu, got[0])
                names = ["y", "dx", "dw", "db"] + (["dres"] if residual
                                                   else [])
                vs64 = {k: max_err(t, ref[k], ref["dx_scale"] if k == "dx"
                                   else 0.0) for k, t in zip(names, got)}
                vs64.update(rm=max_err(kernel_state[0], ref["rm"]),
                            rv=max_err(kernel_state[1], ref["rv"]))
                agree = (got[0] > 0) == (twin[0] > 0)
                apart = 1.0 - agree.double().mean().item()
                vs_twin = {"y": rel_err(got[0], twin[0])}
                vs_twin.update({k: rel_err(got[i], twin[i], agree)
                                for i, k in enumerate(names) if k in (
                                    "dx", "dres")})
                tag = (f"K6 {rows}x{c} {str(dtype)[6:]} relu {relu} residual "
                       f"{residual}")
                limits = {k: K6_TOL[dtype] if k in ("y", "dx", "dres")
                          else 1e-4 for k in vs64}
                if (any(vs64[k] > limits[k] for k in vs64)
                        or max(vs_twin.values()) > K6_REL[dtype]
                        or apart > 0.01 or int(kernel_state[2]) != 1):
                    raise AssertionError(
                        f"[bn] {tag}: against float64 {vs64} (limits "
                        f"{limits}); against the twin {vs_twin}, masks apart "
                        f"on {apart:.2e}")
                errs = dict(float64=vs64, twin=vs_twin, masks_apart=apart)
                if dtype != torch.bfloat16:
                    continue
                passes = 8 if residual else 5
                row = dict(name="K6", shape=(rows, c), dtype="bf16",
                           relu=relu, residual=residual, count=count,
                           errors=errs, **bound(passes * x.numel() * 2, 0,
                                                "bf16"))
                state = moving()
                row.update(
                    kernel_ms=kernel_ms(lambda: run(B.batch_norm_act, state)),
                    device_ms=device_ms(lambda: run(B.batch_norm_act, state)),
                    plain_ms=device_ms(
                        lambda: run(B.batch_norm_act_plain, moving())),
                    library_ms=device_ms(lambda: run(
                        lambda x, w, b, rm, rv, s, r, relu: B.epilogue(
                            F.batch_norm(x, rm, rv, w, b, True, B.MOMENTUM,
                                         B.EPS), r, relu),
                        moving())))
                alone = row["kernel_ms"] or row["device_ms"]
                row["share_of_bound"] = row["bound_ms"] / alone
                per_step += 4 * count * alone
                per_step_bound += 4 * count * row["bound_ms"]
                log(f"  {tag}: x{count}, forward and backward {alone:.4f} ms "
                    f"alone ({ms_or_not(row['kernel_ms'])} by the profiler), "
                    f"{row['device_ms']:.4f} ms in a row; bound "
                    f"{row['bound_us']:.1f} us, {100 * row['share_of_bound']:.1f}"
                    f"% of it; twin {row['plain_ms']:.4f} ms, library "
                    f"{row['library_ms']:.4f} ms; errors {errs}")
                rows_out.append(row)
        log(f"[bn] K6 at {rows}x{c}: bf16 and float32 within their limits of "
            f"float64 ({K6_TOL}; 1e-4) and of the twin ({K6_REL})")
    log(f"[bn] K6 in a ResNet-50 SSL step (4 encoder calls of 53 batch "
        f"norms): {per_step:.2f} ms of kernels alone, bound "
        f"{per_step_bound:.2f} ms ({100 * per_step_bound / per_step:.1f}%)")
    captured = bn_capture_counts()
    log(json.dumps({"k6": rows_out, "k6_step_ms": per_step,
                    "k6_step_bound_ms": per_step_bound,
                    "capture_counters": captured}))
    return rows_out


def bn_capture_counts() -> dict:
    """The batch norms of [main]'s step as its CUDA graph is captured, by
    the dispatch's counters: 212 through K6 (4 encoder calls of 53), and
    through torch's only the projectors' 18 of 2-D float32 rows."""
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.train.backbone_train import SSLTrainer
    from sm3x_torch.utils import profiling

    cfg = stage1_cfg("bn", "resnet50", MAIN_BATCH)
    trainer = SSLTrainer(cfg)
    data = synthetic_paired_data(MAIN_BATCH * 2, canvas=320, seed=0)
    batches = [([torch.from_numpy(x).cuda() for x in
                 (b.derm, b.derm_hw, b.clinic, b.clinic_hw)], trainer._meta(b))
               for b in data.batches(MAIN_BATCH, 0, cfg.run.seed)]
    trainer.train_step(*batches[0][0], 0, *batches[0][1])   # eager
    profiling.take()
    profiling.record(True)
    try:
        trainer.train_step(*batches[1][0], 1, *batches[1][1])  # the capture
        torch.cuda.synchronize()
    finally:
        profiling.record(False)
    counters = profiling.take().counters
    got = {k: counters.get(k, 0) for k in (
        "trainer.graph_captures", "model.bn_kernel", "model.bn_library")}
    log(f"[bn] the counters of [main]'s step captured as a CUDA graph: {got}")
    drop_graph(trainer)
    if got != {"trainer.graph_captures": 1, "model.bn_kernel": 212,
               "model.bn_library": 18}:
        raise AssertionError(f"[bn] a capture's batch norms {got}, expected "
                             f"212 through K6 and the projectors' 18")
    return got


def phase_serving() -> None:
    """`--only serve`: [main], [stage2] and [eval] for the weights, then
    [infer] and [serve] on them."""
    phase_main()
    phase_stage2()
    reference = phase_eval()[1]
    phase_infer(reference)
    phase_serve(reference)


def phase_exporting() -> None:
    """`--only export`: [main], [stage2] and [eval] for the weights, then
    [export] on them."""
    phase_main()
    phase_stage2()
    phase_export(phase_eval()[1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="also write the device-time tables of three steps "
                   "of the main, stage2, eval, probe, vit and dist phases to "
                   "DIR")
    p.add_argument("--only", metavar="PHASES", default=None,
                   help="comma-separated phases to run after device and "
                   "build (a quick check; the full run takes every phase)")
    p.add_argument("--dist-worker", metavar="BACKEND", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--dist-legs", metavar="RECIPES", default="main",
                   help=argparse.SUPPRESS)
    p.add_argument("--tp-worker", metavar="BACKEND", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--export-worker", metavar="DIR", default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import sm3x_torch  # noqa: F401  fails outside a checkout of the repo

    if args.dist_worker:
        return dist_worker(args.dist_worker, args.dist_legs.split(","))
    if args.tp_worker:
        return tp_worker(args.tp_worker)
    if args.export_worker:
        return export_worker(args.export_worker)

    seconds = {}

    def run(name, fn, *a):
        """fn(*a), its seconds logged; the allocator's cache given back
        after it."""
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t, 1)
        log(f"[{name}] phase took {seconds[name]:.1f} s")
        torch.cuda.empty_cache()
        return out

    smi = run("device", phase_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run("build", phase_build)
    if args.only:
        alone = {"kernels": phase_kernels, "step": phase_step,
                 "main": lambda: phase_main(args.profile), "feed": phase_feed,
                 "prefetch": phase_prefetch,
                 "dist": lambda: phase_dist(args.profile),
                 "vit": lambda: phase_vit(args.profile), "copy": phase_copy,
                 "vmoe": phase_vmoe, "bn": phase_bn,
                 "crop": phase_crop, "crop_vit": phase_crop_vit,
                 "bnfreq": phase_bnfreq,
                 "tri": phase_tri, "transfer": phase_transfer,
                 "tp": phase_tp, "learn": phase_learn,
                 "serve": phase_serving, "export": phase_exporting}
        for name in args.only.split(","):
            run(name, alone[name])
        log(f"[only] {args.only}: done (a partial run prints no result)")
        return 0
    kernels, floor = run("kernels", phase_kernels)
    run("step", phase_step)
    launches = run("main", phase_main, args.profile)
    crop_launches = run("crop", phase_crop)
    bnfreq_launches = run("bnfreq", phase_bnfreq)
    feed = run("feed", phase_feed)
    prefetch = run("prefetch", phase_prefetch)
    stage2_launches = run("stage2", phase_stage2, args.profile)
    eval_launches, eval_reference = run("eval", phase_eval, args.profile)
    probe_launches = run("probe", phase_probe, args.profile)
    transfer_launches = run("transfer", phase_transfer)
    run("infer", phase_infer, eval_reference)
    serve = run("serve", phase_serve, eval_reference)
    exported = run("export", phase_export, eval_reference)
    del eval_reference
    vit_launches = run("vit", phase_vit, args.profile)
    crop_vit_launches, crop_vit_rows = run("crop_vit", phase_crop_vit)
    for key, rows in crop_vit_rows.items():
        kernels[key]["path_shapes"] += rows
    tri_launches = run("tri", phase_tri)
    dist_launches, recipe_launches = run("dist", phase_dist, args.profile)
    tp = run("tp", phase_tp)
    for key, rows in tp["k3"].items():
        kernels[key]["path_shapes"] += rows
    learn_launches, learn_rows = run("learn", phase_learn)
    for key, rows in learn_rows.items():
        kernels[key]["path_shapes"] += rows
    copy_launches = run("copy", phase_copy)
    run("vmoe", phase_vmoe)
    run("bn", phase_bn)
    log(f"[time] seconds a phase: {seconds}; in all "
        f"{sum(seconds.values()):.1f} s")
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
                 launches_eval=eval_launches[counter],
                 launches_probe=probe_launches[counter],
                 launches_serve=serve["launches"][counter],
                 launches_export=exported["launches"][counter],
                 launches_dist=dist_launches[counter],
                 launches_tp=tp["launches"][counter],
                 launches_crop=crop_launches[counter],
                 launches_bnfreq=bnfreq_launches[counter],
                 launches_crop_vit=crop_vit_launches[counter],
                 launches_tri=tri_launches[counter],
                 launches_dist_crop=recipe_launches["crop"][counter],
                 launches_dist_tri=recipe_launches["tri"][counter],
                 launches_transfer=transfer_launches[counter],
                 launches_learn=learn_launches[counter],
                 launches_feed={f: feed[f]["launches"][counter]
                                for f in FEEDS},
                 launches_prefetch={f: prefetch[f][counter]
                                    for f in PREFETCH_FEEDS},
                 launches_per_step={
                     "main": MAIN_PER_STEP.get(counter, 0),
                     "vit": VIT_PER_STEP.get(counter, 0),
                     "stage2": STAGE2_PER_STEP.get(counter, 0),
                     "eval": SUPERVISED_PER_STEP.get(counter, 0),
                     "probe": SUPERVISED_PER_STEP.get(counter, 0),
                     "feed": MAIN_PER_STEP.get(counter, 0),
                     "prefetch": MAIN_PER_STEP.get(counter, 0), "serve": 0,
                     "export": 0,
                     "dist": SSL_PER_STEP.get(counter, 0),
                     "tp": TP_PER_STEP.get(counter, 0),
                     "crop": CROP_PER_STEP.get(counter, 0),
                     "bnfreq": BNFREQ_PER_STEP.get(counter, 0),
                     "crop_vit": VIT_CROP_PER_STEP.get(counter, 0),
                     "tri": VIT_PER_STEP.get(counter, 0),
                     "dist_crop": SSL_PER_STEP.get(counter, 0),
                     "dist_tri": VIT_PER_STEP.get(counter, 0),
                     "transfer": int(counter == "photometric_cuda")},
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
