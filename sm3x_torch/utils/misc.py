"""Run-directory, meter and logger helpers of the CLIs (counterpart of
sm3x/utils/misc.py and of `setup_logger` in sm3x/utils/logging.py; that
package's `sm3x.utils` imports the JAX checkpoint code). The stat writer
and the summary table are in `sm3x_torch.utils.logging`."""

from __future__ import annotations

import glob
import logging
import os
import random
import re
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def increment_path(path, exist_ok: bool = False, sep: str = "_",
                   mkdir: bool = True) -> Path:
    """runs/exp -> runs/exp, runs/exp_2, runs/exp_3, ...; `path` itself
    where it is free or `exist_ok`. With `mkdir` makes the directory (the
    path's parent where it has a suffix)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        suffix = path.suffix
        stem_path = path.with_suffix("")
        nums = []
        for c in glob.glob(f"{stem_path}{sep}*"):
            m = re.search(rf"{re.escape(stem_path.stem)}{sep}(\d+)", c)
            if m:
                nums.append(int(m.group(1)))
        path = Path(f"{stem_path}{sep}{max(nums) + 1 if nums else 2}{suffix}")
    directory = path if path.suffix == "" else path.parent
    if mkdir:
        directory.mkdir(parents=True, exist_ok=True)
    return path


def save_args(args_dict: dict, path: str):
    """Dump config key: value lines, sorted (configs.txt convention)."""
    with open(path, "w") as f:
        for k in sorted(args_dict):
            f.write(f"{k}: {args_dict[k]}\n")


def fix_random_seeds(seed: int = 3407):
    """Seed the host RNGs. Device randomness comes from explicit generators
    (sm3x_torch.core.prng)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class AverageMeter:
    """Running average of a scalar."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        digits = len(str(num_batches))
        fmt = "{:" + str(digits) + "d}"
        self.batch_fmtstr = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        return "\t".join(entries)


class BestRecorder:
    """The best value seen so far of a metric that should fall ("min") or
    rise ("max")."""

    def __init__(self, mode: str, best=None):
        if mode not in ("min", "max"):
            raise ValueError(f"invalid mode {mode!r}")
        self.mode = mode
        if best is None:
            best = sys.maxsize if mode == "min" else -sys.maxsize
        self.best = best

    def update(self, val):
        """Returns (best, improved)."""
        pick = min if self.mode == "min" else max
        improved = val < self.best if self.mode == "min" else val > self.best
        self.best = pick(val, self.best)
        return self.best, improved

    def val(self):
        return self.best


def create_eval_stat(prefix: str, metrics_name, classes_name,
                     mode: str) -> dict:
    """{"<prefix>/<metric>_<class>": mode}, the classes and AVG."""
    return {f"{prefix}/{m}_{c}": mode for m in metrics_name
            for c in list(classes_name) + ["AVG"]}


class _ElapsedFormatter(logging.Formatter):
    """'[0d 00:01:23] name INFO: msg'."""

    def __init__(self):
        super().__init__()
        self.start = time.time()

    def format(self, record):
        elapsed = int(time.time() - self.start)
        d, rem = divmod(elapsed, 86400)
        h, rem = divmod(rem, 3600)
        m, s = divmod(rem, 60)
        return (f"[{d}d {h:02d}:{m:02d}:{s:02d}] {record.name} "
                f"{record.levelname}: {record.getMessage()}")


def setup_logger(output: Optional[str] = None, name: str = "sm3x_torch",
                 rank: Optional[int] = None) -> logging.Logger:
    """stdout on rank 0 only, and a file in `output`: `log.txt` on rank 0,
    `log.txt.rank{N}` on rank N > 0, so that the ranks of one run share
    its directory without mixing their lines. `rank` defaults to this
    process's. Calling it again for a name replaces that logger's
    handlers."""
    if rank is None:
        from sm3x_torch.parallel.collectives import process_info

        rank = process_info()[0]
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = _ElapsedFormatter()
    handlers = [logging.StreamHandler(stream=sys.stdout)] if rank == 0 else []
    if output:
        os.makedirs(output, exist_ok=True)
        fname = "log.txt" + (f".rank{rank}" if rank else "")
        handlers.append(logging.FileHandler(os.path.join(output, fname)))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger
