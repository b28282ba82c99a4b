"""CLI applications of the port's four stages (counterpart of
sm3x/cli/apps.py `backbone_train_main`, `mlc_train_main`, `mlc_eval_main`
and `backbone_eval_main`). Tracebacks are appended to
`<log_path>/error.log`, the reference's convention.

Every app runs on one process or on several: `--coordinator host:port
--num-processes N --process-id i` on each, or one `torchrun
--nproc-per-node N` (one process a GPU). `-b` is then the global batch.
"""

from __future__ import annotations

import os
import traceback

from sm3x_torch.cli.parser import (add_backbone_eval_args, add_mlc_eval_args,
                                   add_mlc_train_args, add_ssl_args,
                                   eval_config, get_parser, mlc_train_config,
                                   ssl_config)
from sm3x_torch.core.config import asdict_flat
from sm3x_torch.parallel.collectives import (broadcast_string,
                                             distributed_initialize,
                                             process_info, shutdown)
from sm3x_torch.utils.misc import (fix_random_seeds, increment_path,
                                   save_args, setup_logger)


def _setup(args, cfg, logger_name: str):
    """The process group first (--coordinator, or torchrun's environment;
    NCCL on the card, gloo for --device cpu), before anything touches a
    device; then the run directory, which rank 0 resolves (a fresh one
    beside an existing name) and every rank takes from it, its configs.txt
    from rank 0, the rank's logger and the host seeds."""
    distributed_initialize(args.coordinator, args.num_processes,
                           args.process_id,
                           backend="gloo" if cfg.run.device == "cpu" else None)
    rank, world = process_info()
    if rank == 0:
        args.log_path = str(increment_path(args.log_path))
    if world > 1:
        args.log_path = broadcast_string(args.log_path)
        os.makedirs(args.log_path, exist_ok=True)
    cfg.run.log_path = args.log_path
    if rank == 0:
        save_args(asdict_flat(cfg), os.path.join(args.log_path, "configs.txt"))
    logger = setup_logger(args.log_path, logger_name, rank=rank)
    fix_random_seeds(cfg.run.seed)
    return logger


def _capture_errors(log_path: str, fn):
    """Run the stage; a traceback goes to `<log_path>/error.log`, and the
    process group, where there is one, is left at the end."""
    try:
        return fn()
    except Exception as e:
        print(e, "\n")
        with open(os.path.join(log_path, "error.log"), "a") as f:
            traceback.print_exc(file=f)
            f.write("\n")
        raise
    finally:
        shutdown()


def _split(cfg, mode: str):
    from sm3x_torch.data.datasets import build_dataset

    return build_dataset(cfg.data.data_name, cfg.data.data_path, mode,
                         cache_size=cfg.data.cache_size,
                         workers=cfg.run.workers,
                         streaming=not cfg.data.cache_images)


def _train_data(cfg, logger):
    data = _split(cfg, "train")
    logger.info(f"Building train data done with {data.n} images loaded.")
    return data


def backbone_train_main(argv=None):
    """Stage 1: SSL pretraining; with --linear-probe, 50 epochs of the
    in-tool linear probe on the frozen encoders afterwards."""
    args = add_ssl_args(get_parser()).parse_args(argv)
    cfg = ssl_config(args)
    logger = _setup(args, cfg, "sm3x_torch.ssl")

    def run():
        from sm3x_torch.train.backbone_train import SSLTrainer, unsupported

        # what the port does not do is refused before the data is read
        problems = unsupported(cfg)
        if problems:
            raise ValueError("; ".join(problems))
        data = None
        if cfg.model.arch_version == "trimodal":
            # the data before the model: the metadata embeddings are sized
            # from this dataset's vocabularies
            data = _train_data(cfg, logger)
            sizes = getattr(data, "meta_vocab_sizes", None)
            if sizes:
                cfg.model.meta_vocab_sizes = tuple(sizes)
                logger.info(f"trimodal metadata vocab sizes: {tuple(sizes)}")
        trainer = SSLTrainer(cfg, logger=logger)
        if data is None:
            data = _train_data(cfg, logger)
        trainer.resume()  # --resume-path
        trainer.fit(data)

        if args.linear_probe:
            from sm3x_torch.models.backbones import feat_dim
            from sm3x_torch.train.linear_probe import (LinearProbe,
                                                       make_ssl_extract_fn)

            extract = make_ssl_extract_fn(
                trainer.model, trainer.device, tuple(cfg.data.mean),
                tuple(cfg.data.std), tuple(cfg.data.img_sz))
            probe = LinearProbe(2 * feat_dim(cfg.model.arch),
                                ft_lr=args.ft_lr, wd=cfg.optim.wd,
                                seed=cfg.run.seed, device=trainer.device)
            best = probe.run(extract, data, _split(cfg, "test"),
                             cfg.optim.batch_size, epochs=args.probe_epochs,
                             label_weights=cfg.optim.label_weights,
                             seed=cfg.run.seed, logger=logger)
            logger.info(f"linear probe best val AUC_AVG: "
                        f"{best['AUC_AVG']:.4f}")

    return _capture_errors(args.log_path, run)


def mlc_train_main(argv=None):
    """Stage 2: DeepCluster training of the MLC head on a frozen stage-1
    extractor (`--extractor-weights`, a `ckp_*.pth` of the port's stage 1)."""
    args = add_mlc_train_args(
        get_parser("sm3x_torch DeepCluster MLC training")).parse_args(argv)
    cfg = mlc_train_config(args)
    logger = _setup(args, cfg, "sm3x_torch.mlc")

    def run():
        from sm3x_torch.train.mlc_train import MLCTrainer
        from sm3x_torch.utils.checkpoint import load_encoder_state

        extractor_state = None
        if cfg.extractor_weights:
            extractor_state = load_encoder_state(cfg.extractor_weights)
        trainer = MLCTrainer(cfg, logger=logger,
                             extractor_state=extractor_state)
        trainer.resume()  # --resume-path: the bank comes with it
        trainer.fit(_train_data(cfg, logger))

    return _capture_errors(args.log_path, run)


def _eval_app(args, cfg, logger, make_trainer):
    """What the two eval apps share: both splits, the trainer from
    --pretrain-path if that file exists, --resume-path, `fit`, and
    `results.csv` of the test split in the run directory."""

    def run():
        train, test = _split(cfg, "train"), _split(cfg, "test")
        logger.info(f"train {train.n} / test {test.n} images loaded.")
        path = cfg.run.pretrain_path
        if path and os.path.isfile(path):
            logger.info(f"Loading pre-trained weights from '{path}' ...")
        else:
            path = None
        trainer = make_trainer(path)
        trainer.resume()  # --resume-path
        best = trainer.fit(train, test)
        logger.info(f"Best val AUC_AVG: {best:.4f}")
        out_csv = os.path.join(args.log_path, "results.csv")
        trainer.write_results(test, out_csv)
        logger.info(f"Wrote {out_csv}")

    return _capture_errors(args.log_path, run)


def mlc_eval_main(argv=None):
    """Supervised finetune / eval of the MLC model (`--pretrain-path`, a
    `ckp_*.pth` of the port's stage 2 or a released `best_*.pth`)."""
    args = add_mlc_eval_args(
        get_parser("sm3x_torch MLC supervised finetune/eval")).parse_args(argv)
    cfg = eval_config(args)
    logger = _setup(args, cfg, "sm3x_torch.mlc_eval")

    def make_trainer(path):
        from sm3x_torch.train.mlc_eval import MLCEvalTrainer
        from sm3x_torch.utils.checkpoint import load_pretrained_state

        return MLCEvalTrainer(
            cfg, logger=logger,
            pretrained_state=path and load_pretrained_state(path))

    return _eval_app(args, cfg, logger, make_trainer)


def backbone_eval_main(argv=None):
    """Linear eval of a stage-1 checkpoint's two encoders
    (`--pretrain-path`, a `ckp_*.pth` of the port's stage 1)."""
    args = add_backbone_eval_args(
        get_parser("sm3x_torch backbone linear eval")).parse_args(argv)
    cfg = eval_config(args)
    logger = _setup(args, cfg, "sm3x_torch.backbone_eval")

    def make_trainer(path):
        from sm3x_torch.train.backbone_eval import BackboneEvalTrainer
        from sm3x_torch.utils.checkpoint import load_encoder_state

        return BackboneEvalTrainer(
            cfg, logger=logger,
            encoder_state=path and load_encoder_state(path))

    return _eval_app(args, cfg, logger, make_trainer)
