#!/usr/bin/env python
"""The learning demo's stage 1 alone, in either package: the SSL loss an
epoch of the JAX package (on the CPU) or of the PyTorch port (on the card
by default), in bf16 or float32, so that the two can be read side by side
over seeds.

    python tools/compare_ssl_loss.py jax 200 bf16 --seed 1
    python tools/compare_ssl_loss.py torch 200 bf16 --seed 1 --device cpu
    python tools/compare_ssl_loss.py jax 200 bf16 --seed 1 --demo

One package a process (the port never imports JAX). The data are the
demo's `make_structured_dataset(n=192)` (each package's own copy, equal,
and always seed 0's, as in the port's demo); the run is the demo's stage
1: resnet18 at 96 x 96, batch 48, v32, projection 64, T 0.1, lr 1e-3,
`amp` from the third argument, the trainer's seed from `--seed`. Prints
one JSON line: the package, the precision, the seed, the epochs' losses,
the loss at epochs 0, 50, 100, 150 and the last (`at`), and `L10`, the
mean loss of the last 10 epochs. The JAX side runs with the `XLA_FLAGS`
of its environment (`--xla_allow_excess_precision=false` rounds as the
port does), and the line says which; the port's line says whether cuDNN
may run its float32 convolutions in TF32 (torch's default).

`--demo` runs the package's whole learning demo instead (`--full-pipeline`,
the demo's own flags at their defaults, `epochs` SSL epochs) at `--seed`,
and its line holds the three AUCs and whether control < SSL probe <
stage-2 eval. The JAX package's demo fixes its seed at 0; here its
`RunConfig` and `LinearProbe` take `--seed` instead, and nothing else
changes.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MARK_EPOCHS = (0, 50, 100, 150)
DATA_N, IMG_SZ, BATCH = 192, 96, 48   # the demo's stage 1


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def summarize(losses) -> dict:
    """The loss at epochs 0, 50, 100, 150 and the last one (those the run
    reached), and L10, the mean of the last 10 epochs' losses."""
    at = {str(e): losses[e] for e in MARK_EPOCHS if e < len(losses) - 1}
    if losses:
        at[str(len(losses) - 1)] = losses[-1]
    tail = losses[-10:]
    return {"at": at, "L10": sum(tail) / len(tail) if tail else None}


class _Tee(io.TextIOBase):
    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _jax_demo(args, log_path) -> dict:
    """The JAX package's demo with `--full-pipeline` at `args.seed`: its
    trainers' `RunConfig` and its probe's `LinearProbe` take the seed the
    demo writes as 0. Returns the AUCs its lines print."""
    import sm3x.core.config as config
    import sm3x.train.linear_probe as linear_probe

    run_config, probe = config.RunConfig, linear_probe.LinearProbe
    config.RunConfig = lambda **kw: run_config(**{**kw, "seed": args.seed})
    linear_probe.LinearProbe = lambda *a, **kw: probe(
        *a, **{**kw, "seed": args.seed})
    demo = _load("tools/demo_synthetic_e2e.py", "demo_jax")
    argv = sys.argv
    sys.argv = ["demo_synthetic_e2e.py", "--epochs", str(args.epochs),
                "--full-pipeline", "--log-path", log_path]
    tee = _Tee(sys.stderr)
    try:
        with contextlib.redirect_stdout(tee):
            demo.main()
    finally:
        sys.argv = argv
        config.RunConfig, linear_probe.LinearProbe = run_config, probe
    text = tee.buf.getvalue()

    def auc(pattern):
        return float(re.search(pattern + r" ([0-9.]+)", text).group(1))

    losses = [float(v) for v in re.findall(
        r"Epoch \d+: loss ([0-9.]+)", open(os.path.join(log_path,
                                                        "log.txt")).read())]
    return dict(auc_random=auc("random-init probe: best val AUC_AVG"),
                auc_ssl=auc("SSL-pretrained probe: best val AUC_AVG"),
                auc_eval=auc("supervised eval best AUC"),
                ssl_losses=losses)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("package", choices=("jax", "torch"))
    p.add_argument("epochs", type=int)
    p.add_argument("precision", choices=("bf16", "f32"))
    p.add_argument("--seed", type=int, default=0,
                   help="the trainer's seed (the data are seed 0's)")
    p.add_argument("--device", default="cuda",
                   help="the port's device (the JAX package runs on the CPU)")
    p.add_argument("--demo", action="store_true",
                   help="run the package's whole demo (--full-pipeline, "
                   "always bf16) and report its AUCs")
    p.add_argument("--log-path", default=None)
    args = p.parse_args(argv)
    if args.demo and args.precision != "bf16":
        p.error("--demo runs the demo's own bf16 recipe")
    log_path = args.log_path or os.path.join(
        tempfile.gettempdir(),
        f"compare_ssl_{args.package}_{args.precision}_s{args.seed}"
        + ("_demo" if args.demo else ""))
    # the trainers append to log.txt, which is read back for the losses
    with contextlib.suppress(FileNotFoundError):
        os.remove(os.path.join(log_path, "log.txt"))
    out = {"package": args.package, "precision": args.precision,
           "seed": args.seed}
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        out["xla_flags"] = os.environ.get("XLA_FLAGS", "")
    else:
        import torch

        out["device"] = args.device
        out["cudnn_tf32"] = torch.backends.cudnn.allow_tf32
    if args.demo:
        if args.package == "jax":
            res = _jax_demo(args, log_path)
        else:
            demo = _load("tools/demo_synthetic_e2e_torch.py", "demo_torch")
            res = demo.main(["--epochs", str(args.epochs), "--full-pipeline",
                             "--seed", str(args.seed), "--device",
                             args.device, "--log-path", log_path])
        losses = res["ssl_losses"]
        out.update({k: res[k] for k in ("auc_random", "auc_ssl",
                                        "auc_eval")})
        out["order"] = res["auc_random"] < res["auc_ssl"] < res["auc_eval"]
    else:
        if args.package == "jax":
            demo = _load("tools/demo_synthetic_e2e.py", "demo_jax")
            from sm3x.core.config import (DataConfig, ModelConfig,
                                          OptimConfig, RunConfig, SSLConfig)
            from sm3x.train.backbone_train import SSLTrainer
            run_kw = {}
        else:
            demo = _load("tools/demo_synthetic_e2e_torch.py", "demo_torch")
            from sm3x_torch.core.config import (DataConfig, ModelConfig,
                                                OptimConfig, RunConfig,
                                                SSLConfig)
            from sm3x_torch.train.backbone_train import SSLTrainer
            run_kw = {"device": args.device}
        train, _ = demo.make_structured_dataset(n=DATA_N)
        cfg = SSLConfig(
            data=DataConfig(img_sz=(IMG_SZ, IMG_SZ), mean=(0.5,) * 3,
                            std=(0.25,) * 3),
            model=ModelConfig(arch="resnet18", arch_version="v32",
                              proj_dim=64, temperature=0.1),
            optim=OptimConfig(epochs=args.epochs, batch_size=BATCH,
                              base_lr=1e-3, amp=args.precision == "bf16"),
            run=RunConfig(log_path=log_path, seed=args.seed,
                          save_freq=10 ** 6, ckpt_freq=10 ** 6,
                          print_freq=10 ** 6, **run_kw))
        SSLTrainer(cfg).fit(train)
        log = open(os.path.join(log_path, "log.txt")).read()
        losses = [float(v) for v in re.findall(r"Epoch \d+: loss ([0-9.]+)",
                                               log)]
    out.update(summarize(losses))
    out["losses"] = losses
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
