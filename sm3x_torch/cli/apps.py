"""CLI applications of the port's stages 1 and 2 (counterpart of
sm3x/cli/apps.py `backbone_train_main` and `mlc_train_main`). Tracebacks
are appended to `<log_path>/error.log`, the reference's convention."""

from __future__ import annotations

import os
import traceback

from sm3x_torch.cli.parser import (add_mlc_train_args, add_ssl_args,
                                   get_parser, mlc_train_config, ssl_config)
from sm3x_torch.core.config import asdict_flat
from sm3x_torch.utils.misc import (fix_random_seeds, increment_path,
                                   save_args, setup_logger)


def _setup(args, cfg, logger_name: str):
    """The run directory (a fresh one beside an existing name), its
    configs.txt, the logger and the host seeds."""
    if args.coordinator:
        raise SystemExit("--coordinator (multi-process) is not in the PyTorch "
                         "port yet (ROADMAP.md, slice D)")
    args.log_path = str(increment_path(args.log_path))
    cfg.run.log_path = args.log_path
    save_args(asdict_flat(cfg), os.path.join(args.log_path, "configs.txt"))
    logger = setup_logger(args.log_path, logger_name)
    fix_random_seeds(cfg.run.seed)
    return logger


def _capture_errors(log_path: str, fn):
    try:
        return fn()
    except Exception as e:
        print(e, "\n")
        with open(os.path.join(log_path, "error.log"), "a") as f:
            traceback.print_exc(file=f)
            f.write("\n")
        raise


def _train_data(cfg, logger):
    from sm3x_torch.data.datasets import build_dataset

    data = build_dataset(cfg.data.data_name, cfg.data.data_path, "train",
                         cache_size=cfg.data.cache_size,
                         workers=cfg.run.workers)
    logger.info(f"Building train data done with {data.n} images loaded.")
    return data


def backbone_train_main(argv=None):
    args = add_ssl_args(get_parser()).parse_args(argv)
    if args.linear_probe:
        raise SystemExit("--linear-probe is not in the PyTorch port yet "
                         "(ROADMAP.md, slice C)")
    cfg = ssl_config(args)
    logger = _setup(args, cfg, "sm3x_torch.ssl")

    def run():
        from sm3x_torch.train.backbone_train import SSLTrainer

        trainer = SSLTrainer(cfg, logger=logger)
        trainer.fit(_train_data(cfg, logger))

    return _capture_errors(args.log_path, run)


def mlc_train_main(argv=None):
    """Stage 2: DeepCluster training of the MLC head on a frozen stage-1
    extractor (`--extractor-weights`, a `ckp_*.pth` of the port's stage 1)."""
    args = add_mlc_train_args(
        get_parser("sm3x_torch DeepCluster MLC training")).parse_args(argv)
    cfg = mlc_train_config(args)
    logger = _setup(args, cfg, "sm3x_torch.mlc")

    def run():
        from sm3x_torch.train.mlc_train import (MLCTrainer,
                                                load_extractor_state)

        extractor_state = None
        if cfg.extractor_weights:
            extractor_state = load_extractor_state(cfg.extractor_weights)
        trainer = MLCTrainer(cfg, logger=logger,
                             extractor_state=extractor_state)
        trainer.fit(_train_data(cfg, logger))

    return _capture_errors(args.log_path, run)
