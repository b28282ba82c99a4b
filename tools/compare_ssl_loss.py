#!/usr/bin/env python
"""The learning demo's stage 1 alone, on the CPU, in either package: the
SSL loss an epoch of the JAX package or of the PyTorch port, in bf16 or
float32, so that the two can be read side by side.

    python tools/compare_ssl_loss.py jax 200 f32
    python tools/compare_ssl_loss.py torch 200 bf16

One package a process (the port never imports JAX). The data are the
demo's `make_structured_dataset(n=192)` (each package's own copy, equal
for one seed); the run is the demo's stage 1: resnet18 at 96 x 96, batch
48, v32, projection 64, T 0.1, lr 1e-3, seed 0, `amp` from the third
argument. Prints one JSON line: the package, the precision and the
epochs' losses.
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("package", choices=("jax", "torch"))
    p.add_argument("epochs", type=int)
    p.add_argument("precision", choices=("bf16", "f32"))
    p.add_argument("--log-path", default=None)
    args = p.parse_args(argv)
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        demo = _load("tools/demo_synthetic_e2e.py", "demo_jax")
        from sm3x.core.config import (DataConfig, ModelConfig, OptimConfig,
                                      RunConfig, SSLConfig)
        from sm3x.train.backbone_train import SSLTrainer
        run_kw = {}
    else:
        demo = _load("tools/demo_synthetic_e2e_torch.py", "demo_torch")
        from sm3x_torch.core.config import (DataConfig, ModelConfig,
                                            OptimConfig, RunConfig,
                                            SSLConfig)
        from sm3x_torch.train.backbone_train import SSLTrainer
        run_kw = {"device": "cpu"}
    log_path = args.log_path or os.path.join(
        tempfile.gettempdir(), f"compare_ssl_{args.package}_{args.precision}")
    train, _ = demo.make_structured_dataset(n=192)
    cfg = SSLConfig(
        data=DataConfig(img_sz=(96, 96), mean=(0.5,) * 3, std=(0.25,) * 3),
        model=ModelConfig(arch="resnet18", arch_version="v32", proj_dim=64,
                          temperature=0.1),
        optim=OptimConfig(epochs=args.epochs, batch_size=48, base_lr=1e-3,
                          amp=args.precision == "bf16"),
        run=RunConfig(log_path=log_path, seed=0, save_freq=10 ** 6,
                      ckpt_freq=10 ** 6, print_freq=10 ** 6, **run_kw))
    trainer = SSLTrainer(cfg)
    trainer.fit(train)
    log = open(os.path.join(log_path, "log.txt")).read()
    import re

    losses = [float(v) for v in re.findall(r"Epoch \d+: loss ([0-9.]+)", log)]
    out = {"package": args.package, "precision": args.precision,
           "losses": losses}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
