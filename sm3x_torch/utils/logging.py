"""The optional TensorBoard / wandb sink, the epoch summary table and the
rate-limited log helpers (counterpart of sm3x/utils/logging.py; the logger
itself is `sm3x_torch.utils.misc.setup_logger`, re-exported here under the
reference's module).

`tensorboard` and `wandb` are optional packages. A `StatWriter` asked for
one that cannot be imported or started says so once, through its logger,
and goes on without it: the stats then reach only the run's log file, as
a line an epoch. It never raises.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from sm3x_torch.utils.misc import setup_logger  # noqa: F401

_LOG_COUNTS: dict = {}
_LOG_TIMES: dict = {}


def log_first_n(logger, msg: str, n: int = 1, key: Optional[str] = None):
    key = key or msg
    _LOG_COUNTS[key] = _LOG_COUNTS.get(key, 0) + 1
    if _LOG_COUNTS[key] <= n:
        logger.info(msg)


def log_every_n(logger, msg: str, n: int = 1, key: Optional[str] = None):
    key = key or msg
    _LOG_COUNTS[key] = _LOG_COUNTS.get(key, 0) + 1
    if (_LOG_COUNTS[key] - 1) % n == 0:
        logger.info(msg)


def log_every_n_seconds(logger, msg: str, n: int = 1,
                        key: Optional[str] = None):
    key = key or msg
    now = time.time()
    last = _LOG_TIMES.get(key)
    if last is None or now - last >= n:
        _LOG_TIMES[key] = now
        logger.info(msg)


class StatWriter:
    """Scalars of an epoch to TensorBoard (`<log_path>/tb_log`) and wandb
    where asked for and available, else to `logger` alone. Only rank 0 of
    a process group writes (the ranks' stats are the same)."""

    def __init__(self, log_path: str, tensorboard: bool = False,
                 wandb: bool = False, project: str = "sm3x", config=None,
                 logger=None):
        from sm3x_torch.parallel.collectives import is_main_process

        self.log_path = log_path
        self.logger = logger
        self.tb = None
        self.wb = None
        self.to_log = False   # a sink was asked for and is missing
        if not is_main_process():
            return
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(log_path, "tb_log"))
            except Exception as e:
                self._missing("tensorboard", e)
        if wandb:
            try:
                import wandb as wb

                wb.init(project=project, dir=log_path, config=config)
                self.wb = wb
            except Exception as e:
                self._missing("wandb", e)

    def _missing(self, name: str, err: Exception):
        self.to_log = True
        if self.logger is not None:
            log_first_n(self.logger, f"--{name} was asked for but cannot be "
                        f"used here ({type(err).__name__}: {err}); the stats "
                        f"go to the log file instead", key=f"no-{name}")

    def define_summaries(self, summaries: dict):
        """wandb `define_metric` summaries ({metric: "min" | "max"})."""
        if self.wb:
            for k, v in summaries.items():
                try:
                    self.wb.define_metric(k, summary=v)
                except Exception:
                    pass

    def log(self, stats: dict, step: int, prefix: str = ""):
        items = {f"{prefix}{k}": v for k, v in stats.items()}
        if self.tb:
            for k, v in items.items():
                self.tb.add_scalar(k, v, step)
        if self.wb:
            self.wb.log(items, step=step)
        if self.to_log and self.logger is not None:
            self.logger.info(f"stats step {step}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in items.items()))

    def close(self):
        if self.tb:
            self.tb.flush()
            self.tb.close()
        if self.wb:
            # the run's text logs go up before the run is closed
            for name in ("outputs.log", "log.txt", "configs.txt"):
                path = os.path.join(self.log_path, name)
                if os.path.isfile(path):
                    try:
                        self.wb.save(path, base_path=self.log_path)
                    except Exception:
                        pass
            self.wb.finish()


def generate_stat_text(train_stat, val_stat, summary_stat, metrics_name,
                       classes_name) -> str:
    """The epoch's table: `metric: train/best train | val/best val` a
    line, the classes and AVG of each metric."""
    text = ""
    for m in metrics_name:
        text += "------\n"
        for c in list(classes_name) + ["AVG"]:
            name = f"{m}_{c}"
            text += "{}: {:.4f}/{:.4f} | ".format(
                name, train_stat[name], summary_stat[f"train/{name}"].val())
            text += "{:.4f}/{:.4f}\n".format(
                val_stat[name], summary_stat[f"val/{name}"].val())
    return text
