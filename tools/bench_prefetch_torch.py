#!/usr/bin/env python
"""Measure the port's four device-feeding strategies on one NVIDIA GPU (the
twin of tools/bench_prefetch.py).

  sync      the bare dataset: the trainer uploads each batch on the step
            path (--device-feed host)
  prefetch  PrefetchData: a producer thread copies batches through a pinned
            ring on a side stream, `depth` batches ahead
  resident  DeviceData: every canvas lives on the card, no upload a step
  stream    PrefetchData over the streaming dataset (--no-cache-images):
            decode and upload both ride under compute

Runs the real stage-1 step (dual encoder, K1 photometric, the NT-Xent
kernels, AdamW, bf16 autocast) over a fake Derm7pt tree written to a
temporary directory, so the whole gather and upload path is exercised: one
warm epoch, then timed epochs, each ended by a loss read. Prints one JSON
line a feed: the JAX tool's `metric` (ssl_feed_{feed}_images_per_sec),
`value` (the median over the timed epochs of 4 x batch x steps / seconds)
and `unit`, and `device`: the card's name and power limit as nvidia-smi
gives them, or "cpu". Standard error gets one line a feed with the epochs'
seconds and the kernels' launches.

    python tools/bench_prefetch_torch.py [n_cases] [batch] [epochs] [arch]
                                        # 160 32 4 resnet50
    python tools/bench_prefetch_torch.py 12 4 2 resnet18 --img-sz 32 32 \\
        --tree-size 48 --device cpu    # a check of the script

It needs a card and exits with a message without one; `--device cpu` runs
the same code at whatever toy size it is given (a check of the script, not
a measurement). It leaves nothing behind.
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

CACHE_SIZE = 256   # the canvas side, as the JAX tool's


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count, by name."""
    from sm3x_torch.ops import counted_kernels

    return {fn.__name__: fn.launches for fn in counted_kernels()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_cases", nargs="?", type=int, default=160)
    p.add_argument("batch", nargs="?", type=int, default=32)
    p.add_argument("epochs", nargs="?", type=int, default=4,
                   help="1 warm + the rest timed")
    p.add_argument("arch", nargs="?", default="resnet50")
    p.add_argument("--img-sz", nargs=2, type=int, default=[224, 224])
    p.add_argument("--tree-size", type=int, default=300,
                   help="the fake tree's image side")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.epochs < 2:
        sys.exit("epochs must be >= 2 (first epoch is compile warmup)")

    import torch

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("bench_prefetch_torch: torch.cuda.is_available() is false; the "
              "benchmark runs on an NVIDIA GPU (--device cpu only checks the "
              "script)", file=sys.stderr)
        return 1

    from sm3x_torch.core.config import (DataConfig, ModelConfig, OptimConfig,
                                        RunConfig, SSLConfig)
    from sm3x_torch.data.datasets import build_dataset
    from sm3x_torch.data.device_data import DeviceData
    from sm3x_torch.data.prefetch import PrefetchData
    from sm3x_torch.data.synthetic import make_fake_derm7pt
    from sm3x_torch.train.backbone_train import SSLTrainer
    from sm3x_torch.utils.timing import nvidia_smi_name_and_limit

    batch, arch = args.batch, args.arch
    quiet = logging.getLogger("bench_prefetch_torch")  # stdout is the JSON's
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    with tempfile.TemporaryDirectory() as tmp:
        root = make_fake_derm7pt(os.path.join(tmp, "derm7pt"),
                                 n_cases=args.n_cases,
                                 img_size=args.tree_size)
        data = build_dataset("SevenPCBaseDataset", root, "train",
                             cache_size=CACHE_SIZE)
        cfg = SSLConfig(
            data=DataConfig(img_sz=tuple(args.img_sz), cache_size=CACHE_SIZE),
            model=ModelConfig(arch=arch, arch_version="v32", proj_dim=128,
                              temperature=0.1, use_pallas_augment=True),
            optim=OptimConfig(epochs=1, batch_size=batch, base_lr=1e-6,
                              amp=True),
            run=RunConfig(log_path=os.path.join(tmp, "log"), seed=0,
                          print_freq=10**9, device=args.device),
        )
        trainer = SSLTrainer(cfg, logger=quiet)
        device = trainer.device
        steps = data.steps_per_epoch(batch)
        upload_mb = 2 * batch * CACHE_SIZE * CACHE_SIZE * 3 / 1e6
        variants = {
            "sync": lambda: data,
            "prefetch": lambda: PrefetchData(data, device, depth=2),
            "resident": lambda: DeviceData(data, device),
            "stream": lambda: PrefetchData(
                build_dataset("SevenPCBaseDataset", root, "train",
                              cache_size=CACHE_SIZE, streaming=True),
                device, depth=2),
        }
        name_and_limit = nvidia_smi_name_and_limit() if on_card else "cpu"
        for name, make in variants.items():
            before = kernel_counts()
            feed = make()
            trainer.train_epoch(feed, 0)  # warm: cuDNN, allocator, upload
            seconds, rates = [], []
            for e in range(1, args.epochs):
                t0 = time.perf_counter()
                trainer.train_epoch(feed, e)  # ends with a loss value read
                seconds.append(time.perf_counter() - t0)
                rates.append(4 * batch * steps / seconds[-1])
            launches = {k: v - before[k] for k, v in kernel_counts().items()}
            print(f"[{name}] {args.epochs} epochs of {steps} steps, timed "
                  f"seconds {seconds}, kernel launches "
                  f"{json.dumps(launches)}", file=sys.stderr)
            print(json.dumps({
                "metric": f"ssl_feed_{name}_images_per_sec",
                "value": statistics.median(rates),
                "unit": (f"images/sec ({arch}, b={batch}, {steps} "
                         f"steps/epoch, {upload_mb:.1f} MB canvases/step, "
                         f"median of {len(rates)} epochs)"),
                "device": name_and_limit,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
