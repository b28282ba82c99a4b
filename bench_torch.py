#!/usr/bin/env python
"""Headline benchmark of the PyTorch port: stage-1 SSL pretrain throughput
on one NVIDIA GPU (the counterpart of bench.py), and with --stage the step
of each later stage (the counterpart of tools/bench_stages.py).

    python3 bench_torch.py [batch] [steps] [arch]          # 96 30 resnet50
    python3 bench_torch.py 64 30 vit_b16 --use-checkpoint flash
    python3 bench_torch.py --bn-stat-freq 4                # bench.py's bn4
    python3 bench_torch.py --negatives global              # negatives_global
    python3 bench_torch.py --stage mlc_train               # batch 256
    python3 bench_torch.py --stage mlc_eval                # batch 128
    python3 bench_torch.py --stage backbone_eval           # batch 128

`--stage ssl` (the default) measures the whole recipe step of run.sh's
stage 1 through `SSLTrainer`'s `make_ssl_train_step` (dual encoder,
224x224, 2 views a modality, v32, proj 128, T 0.1, --world-size 2, AdamW,
bf16 autocast), everything after the uint8 canvas upload, on in-memory
synthetic canvases, and counts every augmented image pushed through an
encoder: 4 a paired sample a step, as bench.py counts them. It takes
bench.py's two secondary modes, each a line of its own: `--bn-stat-freq
K` (EXPERIMENTAL, off-recipe: the eval-BN fast step on every step whose
index is not a multiple of K, after 2K warm-up steps, as bench.py runs
it; the metric ends `_bn_stat_freq{K}`) and `--negatives global` (NT-Xent
over the whole batch; `_negatives_global`). The other
stages take run.sh's recipes, through their trainers' `train_step`, and
count 2 images a paired sample (one view a modality):
  mlc_train      stage 2: MLCTrainer, frozen extractor, v4 projectors of
                 512, 1 head, ff 128, dropout 0.1, T 1, lr 1e-4, float32,
                 a bank of 1024 slots (stage2_mlc)
  mlc_eval       MLCEvalTrainer, --finetune projector, v4 / 512, 1 head,
                 ff 128, lr 1e-3, float32 (stage2_eval)
  backbone_eval  BackboneEvalTrainer, --finetune fc, lr 1e-3, bf16
                 autocast (stage1_eval)

Prints ONE JSON line:
  metric, value, unit, vs_baseline   bench.py's keys; `value` is images/s
                     over a window of `steps` steps that ends in one
                     synchronise; `vs_baseline` is null: no figure of another
                     machine is a baseline for this one
  step_ms, step_ms_min   median and minimum of `steps` more steps, each ended
                     by a synchronise (host clock)
  images_per_sec     images a step over the median step
  device_busy_ms     the sum of kernel and copy times a step under
                     torch.profiler, over 3 further steps (under
                     --bn-stat-freq K, over K: one refresh, K - 1 fast)
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


STAGES = ("ssl", "mlc_train", "mlc_eval", "backbone_eval")
STAGE_BATCH = {"ssl": 96, "mlc_train": 256, "mlc_eval": 128,
               "backbone_eval": 128}
MLC_HEAD = dict(mlc_proj="v4", mlc_proj_dim=512, num_heads=1, sa_dim_ff=128,
                sa_dropout=0.1)
BANK_SLOTS = 1024


def ssl_stage(args, log_path, logger):
    """run.sh's stage-1 step: (step(i), images a step, the trainer)."""
    from sm3x_torch.core import prng
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.train.backbone_train import SSLTrainer

    cfg = SSLConfig()
    m, o, r = cfg.model, cfg.optim, cfg.run
    m.arch, m.arch_version, m.proj_dim, m.temperature = (args.arch, "v32",
                                                         128, 0.1)
    m.use_checkpoint = args.use_checkpoint
    o.batch_size, o.base_lr, o.adam_eps = args.batch, 1e-6, 1e-5
    o.amp = args.device != "cpu"
    cfg.data.img_sz = tuple(args.img_sz)
    m.bn_stat_freq, m.negatives = args.bn_stat_freq, args.negatives
    r.world_size, r.device, r.log_path = 2, args.device, log_path
    trainer = SSLTrainer(cfg, logger=logger)
    # bench.py's batch: the same canvases for both modalities
    batch, _ = canvas_batch(args, trainer.device, 0)

    def step(i):
        fn = trainer.train_step
        if trainer.fast_step is not None and i % trainer.bn_stat_freq:
            fn = trainer.fast_step  # the eval-BN step on K - 1 of K steps
        return fn(*batch, prng.step_seed(r.seed, 0, i))["loss"]

    return step, 4 * args.batch, trainer


def canvas_batch(args, device, seed: int):
    """Synthetic uint8 canvases and valid sizes on `device`, the same for
    both modalities, [derm, derm_hw, clinic, clinic_hw], and the (B, 8)
    labels."""
    from sm3x_torch.data.synthetic import synthetic_canvas_batch

    canvases, hw, labels = synthetic_canvas_batch(args.batch, args.canvas,
                                                  seed)
    return ([torch.from_numpy(x).to(device) for x in (canvases, hw) * 2],
            torch.from_numpy(labels).to(device).long())


def mlc_train_stage(args, log_path, logger):
    """run.sh's stage-2 DeepCluster step over a bank of BANK_SLOTS rows."""
    from sm3x_torch.core import prng
    from sm3x_torch.core.config import MLCTrainConfig
    from sm3x_torch.train.mlc_train import MLCTrainer

    cfg = MLCTrainConfig()
    cfg.model.arch, cfg.model.temperature = args.arch, 1.0
    for k, v in MLC_HEAD.items():
        setattr(cfg.model, k, v)
    cfg.optim.batch_size, cfg.optim.base_lr, cfg.optim.amp = (args.batch,
                                                              1e-4, False)
    cfg.data.img_sz = tuple(args.img_sz)
    cfg.run.device, cfg.run.log_path = args.device, log_path
    trainer = MLCTrainer(cfg, logger=logger)
    device = trainer.device
    batch, _ = canvas_batch(args, device, 0)
    bank = torch.zeros(cfg.model.num_labels, BANK_SLOTS,
                       cfg.model.mlc_proj_dim, device=device)
    assignments = torch.stack([
        torch.arange(BANK_SLOTS, device=device) % c
        for c in cfg.model.num_classes])
    index = torch.arange(args.batch, device=device) % BANK_SLOTS

    def step(i):
        return trainer.train_step(bank, *batch, index, assignments,
                                  prng.step_seed(cfg.run.seed, 0, i))

    return step, 2 * args.batch, trainer


def eval_stage(args, log_path, logger):
    """run.sh's stage2_eval (mlc_eval) or stage1_eval (backbone_eval)
    train step on labelled synthetic canvases."""
    from sm3x_torch.core import prng
    from sm3x_torch.core.config import EvalConfig

    cfg = EvalConfig()
    cfg.model.arch = args.arch
    cfg.optim.batch_size, cfg.optim.base_lr = args.batch, 1e-3
    cfg.data.img_sz = tuple(args.img_sz)
    cfg.train_sz = cfg.test_sz = args.img_sz[0]
    cfg.run.device, cfg.run.log_path = args.device, log_path
    if args.stage == "mlc_eval":
        from sm3x_torch.train.mlc_eval import MLCEvalTrainer as Trainer

        cfg.model.finetune, cfg.optim.amp = "projector", False
        for k, v in MLC_HEAD.items():
            setattr(cfg.model, k, v)
    else:
        from sm3x_torch.train.backbone_eval import (
            BackboneEvalTrainer as Trainer)

        cfg.model.finetune, cfg.optim.amp = "fc", args.device != "cpu"
    trainer = Trainer(cfg, logger=logger)
    batch, labels = canvas_batch(args, trainer.device, 1)

    def step(i):
        return trainer.train_step(*batch, labels,
                                  prng.step_seed(cfg.run.seed, 0, i))[0]

    return step, 2 * args.batch, trainer


STAGE_STEPS = {"ssl": ssl_stage, "mlc_train": mlc_train_stage,
            "mlc_eval": eval_stage, "backbone_eval": eval_stage}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", nargs="?", type=int, default=None,
                   help="the stage's batch (run.sh's by default: 96, 256, "
                   "128, 128)")
    p.add_argument("steps", nargs="?", type=int, default=30)
    p.add_argument("arch", nargs="?", default="resnet50")
    p.add_argument("--stage", default="ssl", choices=STAGES)
    p.add_argument("--use-checkpoint", default=False,
                   choices=("off", "dots", "attn", "flash", "mlp", "attn_mlp"),
                   help="a ViT's activation-memory mode (stage 1)")
    p.add_argument("--img-sz", nargs=2, type=int, default=[224, 224])
    p.add_argument("--canvas", type=int, default=320,
                   help="side of the synthetic uint8 canvases")
    p.add_argument("--bn-stat-freq", type=int, default=1,
                   help="stage 1: refresh the BatchNorm statistics every "
                   "K-th step, the eval-BN fast step on the others "
                   "(EXPERIMENTAL, off-recipe; bench.py's bnK)")
    p.add_argument("--negatives", choices=("local", "global"),
                   default="local",
                   help="stage 1: NT-Xent negatives within the --world-size "
                   "groups or over the whole batch (bench.py's "
                   "negatives_global)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.stage != "ssl" and (args.bn_stat_freq != 1
                                or args.negatives != "local"):
        p.error("--bn-stat-freq and --negatives are stage 1's (--stage ssl)")
    if args.batch is None:
        args.batch = STAGE_BATCH[args.stage]
    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is false; the benchmark "
              "runs on an NVIDIA GPU (--device cpu only checks the script)",
              file=sys.stderr)
        return 1

    from sm3x_torch.utils.timing import (nvidia_smi_name_and_limit,
                                         profile_device)

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with tempfile.TemporaryDirectory() as log_path:
        quiet = logging.getLogger("bench_torch")  # stdout is the JSON line's
        quiet.addHandler(logging.NullHandler())
        quiet.propagate = False
        step, images, trainer = STAGE_STEPS[args.stage](args, log_path, quiet)
        # bench.py's bnK schedule (K clamped as SSLTrainer clamps it): two
        # whole periods warm both steps
        k = max(1, args.bn_stat_freq)
        warmup = 2 * k if k > 1 else WARMUP_STEPS
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        for i in range(warmup):
            step(i)
        sync()
        t0 = time.perf_counter()
        for i in range(args.steps):
            loss = step(warmup + i)
        sync()
        window = time.perf_counter() - t0
        if not torch.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {float(loss)}")
        times = []
        for i in range(args.steps):
            t = time.perf_counter()
            step(warmup + args.steps + i)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        prof = (profile_device(step, PROFILE_STEPS if k == 1 else k)
                if on_card else None)
        peak = torch.cuda.max_memory_allocated() if on_card else None

    size = f"{args.img_sz[0]}x{args.img_sz[1]}"
    if args.stage == "ssl":
        metric = METRIC
        if k > 1:
            metric += f"_bn_stat_freq{k}"
        if args.negatives == "global":
            metric += "_negatives_global"
        unit = (f"images/sec/chip ({size} through {args.arch} fwd+bwd, incl. "
                f"on-device aug)")
    else:
        metric = f"{args.stage}_images_per_sec_per_chip"
        unit = (f"encoder images/sec/chip ({size}, b={args.batch} cases, 2 "
                f"images a case)")
    line = {
        "metric": metric,
        "value": images * args.steps / window,
        "unit": unit,
        "vs_baseline": None,
        "step_ms": statistics.median(times),
        "step_ms_min": min(times),
        "images_per_sec": images / statistics.median(times) * 1e3,
        "device_busy_ms": prof and prof["busy_ms"],
        "launches_per_step": prof and prof["launches"],
        "peak_memory_gib": peak and peak / 2 ** 30,
        "device": nvidia_smi_name_and_limit() if on_card else "cpu",
        "stage": args.stage, "batch": args.batch, "steps": args.steps,
        "arch": args.arch,
    }
    if args.stage == "ssl":
        line["use_checkpoint"] = trainer.remat
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
