#!/usr/bin/env python
"""Measure --bn-stat-freq on the whole stage-1 step on one NVIDIA GPU (the
twin of tools/bench_bn_freq.py).

The standard step (train-mode BatchNorm: batch statistics, running
statistics moved) against the --bn-stat-freq fast step (the model in eval
mode: running statistics, none moved, the same gradient step), and a real
alternating K=4 schedule; dual ResNet-50, v32, projection 128, T 0.1, K1
photometric, the NT-Xent kernels, AdamW, bf16 autocast, on synthetic
320 x 320 canvases, in that order. Each is warmed by 2 steps, then `steps`
steps run with one synchronise at the end, as the JAX tool times them; the
lines it prints are the JAX tool's: the rates, fast/slow, the measured K=4
and the projected K=2/4/8.

Then one JSON line: for each of `slow`, `fast` and `k4` its window ms a
step (from the rate), the median and minimum of `steps` more steps each
ended by a synchronise, and the device's busy ms and kernels and copies a
step under torch.profiler over 4 more steps (one period of K=4); the peak
device memory; and `device`, the card's name and power limit as nvidia-smi
gives them.

    python tools/bench_bn_freq_torch.py [batch] [steps]     # 128 30
    python tools/bench_bn_freq_torch.py 2 2 --arch resnet18 --img-sz 32 32 \\
        --canvas 48 --device cpu       # a check of the script

It needs a card and exits with a message without one; `--device cpu` runs
the same code at whatever toy size it is given (a check of the script, not
a measurement: the device's keys are null and `device` says "cpu"). It
leaves nothing behind.
"""

import argparse
import json
import logging
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

K = 4               # the alternating schedule, as the JAX tool's
WARM_STEPS = 2      # the JAX tool's warm-up of each schedule
PROFILE_STEPS = 4   # one period of K = 4


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", nargs="?", type=int, default=128)
    p.add_argument("steps", nargs="?", type=int, default=30)
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--img-sz", nargs=2, type=int, default=[224, 224])
    p.add_argument("--canvas", type=int, default=320,
                   help="side of the synthetic uint8 canvases")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("bench_bn_freq_torch: torch.cuda.is_available() is false; the "
              "benchmark runs on an NVIDIA GPU (--device cpu only checks the "
              "script)", file=sys.stderr)
        return 1

    from sm3x_torch.core import prng
    from sm3x_torch.core.config import (DataConfig, ModelConfig, OptimConfig,
                                        RunConfig, SSLConfig)
    from sm3x_torch.data.synthetic import synthetic_canvas_batch
    from sm3x_torch.train.backbone_train import SSLTrainer
    from sm3x_torch.utils.timing import (nvidia_smi_name_and_limit,
                                         profile_device)

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    batch = args.batch
    with tempfile.TemporaryDirectory() as log_path:
        cfg = SSLConfig(
            data=DataConfig(img_sz=tuple(args.img_sz), cache_size=args.canvas),
            model=ModelConfig(arch=args.arch, arch_version="v32",
                              proj_dim=128, temperature=0.1,
                              use_pallas_augment=True, bn_stat_freq=K),
            optim=OptimConfig(epochs=1, batch_size=batch, base_lr=1e-6,
                              amp=on_card),
            run=RunConfig(log_path=log_path, seed=0, device=args.device))
        quiet = logging.getLogger("bench_bn_freq_torch")
        quiet.addHandler(logging.NullHandler())
        quiet.propagate = False
        trainer = SSLTrainer(cfg, logger=quiet)
        canvases, hw, _ = synthetic_canvas_batch(batch, args.canvas, 0)
        canvases, hw = (torch.from_numpy(x).to(trainer.device)
                        for x in (canvases, hw))
        if on_card:
            torch.cuda.reset_peak_memory_stats()

        def run(pick, i, at=None):
            """pick(i)'s step on the seed of step `at` (`i` by default)."""
            seed = prng.step_seed(cfg.run.seed, 0, i if at is None else at)
            return pick(i)(canvases, hw, canvases, hw, seed)["loss"]

        def timed(tag, pick):
            """The JAX tool's rate: warm steps, then `steps` dispatched with
            one synchronise; then the single steps and the profile."""
            for i in range(WARM_STEPS):
                float(run(pick, i))
            sync()
            t0 = time.perf_counter()
            for i in range(args.steps):
                loss = run(pick, i, i + WARM_STEPS)
            float(loss)
            dt = (time.perf_counter() - t0) / args.steps
            rate = 4 * batch / dt
            print(f"{tag}: {rate:,.0f} img/s  ({dt * 1e3:.1f} ms/step)",
                  flush=True)
            times = []
            for i in range(args.steps):
                sync()
                t = time.perf_counter()
                run(pick, i, i + WARM_STEPS + args.steps)
                sync()
                times.append((time.perf_counter() - t) * 1e3)
            prof = (profile_device(lambda i: run(pick, i), PROFILE_STEPS)
                    if on_card else None)
            return rate, {"window_ms": dt * 1e3,
                          "median_ms": statistics.median(times),
                          "min_ms": min(times),
                          "device_busy_ms": prof and prof["busy_ms"],
                          "launches_per_step": prof and prof["launches"]}

        # warm the refresh step first so the fast step starts from sane stats
        slow, slow_line = timed(
            f"train-BN step (reference semantics, b={batch})",
            lambda i: trainer.train_step)
        fast, fast_line = timed(f"eval-BN fast step (b={batch})",
                                lambda i: trainer.fast_step)
        k4, k4_line = timed(
            f"alternating --bn-stat-freq {K} (b={batch})",
            lambda i: trainer.train_step if i % K == 0 else trainer.fast_step)
        peak = torch.cuda.max_memory_allocated() if on_card else None

    print(f"\nfast/slow: {fast / slow:.3f}x   measured K={K}: "
          f"{k4 / slow:.3f}x")
    for k in (2, 4, 8):
        eff = k / ((k - 1) / fast + 1 / slow)
        print(f"projected K={k}: {eff:,.0f} img/s ({eff / slow:.3f}x)")
    print(json.dumps({
        "slow": slow_line, "fast": fast_line, "k4": k4_line,
        "peak_memory_gib": peak and peak / 2 ** 30,
        "device": nvidia_smi_name_and_limit() if on_card else "cpu",
        "arch": args.arch, "batch": batch, "steps": args.steps,
        "img_sz": args.img_sz}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
