"""CLI application of the port's stage 1 (counterpart of sm3x/cli/apps.py
`backbone_train_main`). Tracebacks are appended to `<log_path>/error.log`,
the reference's convention."""

from __future__ import annotations

import os
import traceback

from sm3x_torch.cli.parser import add_ssl_args, get_parser, ssl_config
from sm3x_torch.core.config import asdict_flat
from sm3x_torch.utils.misc import (fix_random_seeds, increment_path,
                                   save_args, setup_logger)


def backbone_train_main(argv=None):
    args = add_ssl_args(get_parser()).parse_args(argv)
    if args.linear_probe:
        raise SystemExit("--linear-probe is not in the PyTorch port yet "
                         "(ROADMAP.md, slice C)")
    if args.coordinator:
        raise SystemExit("--coordinator (multi-process) is not in the PyTorch "
                         "port yet (ROADMAP.md, slice D)")
    cfg = ssl_config(args)
    args.log_path = str(increment_path(args.log_path))
    cfg.run.log_path = args.log_path
    save_args(asdict_flat(cfg), os.path.join(args.log_path, "configs.txt"))
    logger = setup_logger(args.log_path, "sm3x_torch.ssl")
    fix_random_seeds(cfg.run.seed)

    try:
        from sm3x.data.datasets import build_dataset  # numpy, cv2, pandas
        from sm3x_torch.train.backbone_train import SSLTrainer

        trainer = SSLTrainer(cfg, logger=logger)
        data = build_dataset(cfg.data.data_name, cfg.data.data_path, "train",
                             cache_size=cfg.data.cache_size,
                             workers=cfg.run.workers)
        logger.info(f"Building train data done with {data.n} images loaded.")
        trainer.fit(data)
    except Exception as e:
        print(e, "\n")
        with open(os.path.join(args.log_path, "error.log"), "a") as f:
            traceback.print_exc(file=f)
            f.write("\n")
        raise
