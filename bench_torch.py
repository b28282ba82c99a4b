#!/usr/bin/env python
"""Headline benchmark of the PyTorch port: stage-1 SSL pretrain throughput
on one NVIDIA GPU (the counterpart of bench.py).

    python3 bench_torch.py [batch] [steps] [arch]          # 96 30 resnet50
    python3 bench_torch.py 64 30 vit_b16 --use-checkpoint flash

Measures the whole recipe step of run.sh's stage 1 through `SSLTrainer`'s
`make_ssl_train_step` (dual encoder, 224x224, 2 views a modality, v32,
proj 128, T 0.1, --world-size 2, AdamW, bf16 autocast), everything after
the uint8 canvas upload, on in-memory synthetic canvases, and counts every
augmented image pushed through an encoder: 4 a paired sample a step, as
bench.py counts them.

Prints ONE JSON line:
  metric, value, unit, vs_baseline   bench.py's keys; `value` is images/s
                     over a window of `steps` steps that ends in one
                     synchronise; `vs_baseline` is null: no figure of another
                     machine is a baseline for this one
  step_ms, step_ms_min   median and minimum of `steps` more steps, each ended
                     by a synchronise (host clock)
  device_busy_ms     the sum of kernel and copy times a step under
                     torch.profiler, over 3 further steps
  launches_per_step  kernels and copies a step in that profile
  peak_memory_gib    torch.cuda.max_memory_allocated over the run
  device             the card's name and power limit, as nvidia-smi gives them

It needs a card and exits with a message without one. `--device cpu` runs
the same code at whatever toy size it is given (a check of the script, not
a measurement: the device's keys are null and `device` says "cpu").
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

METRIC = "ssl_pretrain_images_per_sec_per_chip"
WARMUP_STEPS, PROFILE_STEPS = 3, 3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", nargs="?", type=int, default=96)
    p.add_argument("steps", nargs="?", type=int, default=30)
    p.add_argument("arch", nargs="?", default="resnet50")
    p.add_argument("--use-checkpoint", default=False,
                   choices=("off", "dots", "attn", "flash", "mlp", "attn_mlp"),
                   help="a ViT's activation-memory mode")
    p.add_argument("--img-sz", nargs=2, type=int, default=[224, 224])
    p.add_argument("--canvas", type=int, default=320,
                   help="side of the synthetic uint8 canvases")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is false; the benchmark "
              "runs on an NVIDIA GPU (--device cpu only checks the script)",
              file=sys.stderr)
        return 1

    from sm3x_torch.core import prng
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.data.synthetic import synthetic_canvas_batch
    from sm3x_torch.train.backbone_train import SSLTrainer
    from sm3x_torch.utils.timing import (nvidia_smi_name_and_limit,
                                         profile_device)

    cfg = SSLConfig()
    m, o, r = cfg.model, cfg.optim, cfg.run
    m.arch, m.arch_version, m.proj_dim, m.temperature = (args.arch, "v32",
                                                         128, 0.1)
    m.use_checkpoint = args.use_checkpoint
    o.batch_size, o.base_lr, o.adam_eps, o.amp = args.batch, 1e-6, 1e-5, on_card
    cfg.data.img_sz = tuple(args.img_sz)
    r.world_size, r.device = 2, args.device
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    with tempfile.TemporaryDirectory() as log_path:
        r.log_path = log_path
        quiet = logging.getLogger("bench_torch")  # stdout is the JSON line's
        quiet.addHandler(logging.NullHandler())
        quiet.propagate = False
        trainer = SSLTrainer(cfg, logger=quiet)
        # bench.py's batch: the same canvases for both modalities
        canvases, hw, _ = synthetic_canvas_batch(args.batch, args.canvas, 0)
        batch = [torch.from_numpy(x).to(trainer.device)
                 for x in (canvases, hw, canvases, hw)]

        def step(i):
            return trainer.train_step(*batch, prng.step_seed(r.seed, 0, i))

        if on_card:
            torch.cuda.reset_peak_memory_stats()
        for i in range(WARMUP_STEPS):
            step(i)
        sync()
        t0 = time.perf_counter()
        for i in range(args.steps):
            loss = step(WARMUP_STEPS + i)["loss"]
        sync()
        window = time.perf_counter() - t0
        if not torch.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {float(loss)}")
        times = []
        for i in range(args.steps):
            t = time.perf_counter()
            step(WARMUP_STEPS + args.steps + i)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        prof = profile_device(step, PROFILE_STEPS) if on_card else None
        peak = torch.cuda.max_memory_allocated() if on_card else None

    print(json.dumps({
        "metric": METRIC,
        "value": 4 * args.batch * args.steps / window,
        "unit": f"images/sec/chip ({args.img_sz[0]}x{args.img_sz[1]} through "
                f"{args.arch} fwd+bwd, incl. on-device aug)",
        "vs_baseline": None,
        "step_ms": statistics.median(times),
        "step_ms_min": min(times),
        "device_busy_ms": prof and prof["busy_ms"],
        "launches_per_step": prof and prof["launches"],
        "peak_memory_gib": peak and peak / 2 ** 30,
        "device": nvidia_smi_name_and_limit() if on_card else "cpu",
        "batch": args.batch, "steps": args.steps, "arch": args.arch,
        "use_checkpoint": trainer.remat,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
