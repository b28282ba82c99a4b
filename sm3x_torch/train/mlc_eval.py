"""Supervised finetune / eval of the MLC model (counterpart of
sm3x/train/mlc_eval.py: `MLCEvalTrainer` :35, `_graft` :179). It reads a
stage-2 checkpoint and leaves `best_eval.pth` and `results.csv`.

The freeze policies fc | projector | all decide which tensors AdamW gets
(`common.mlc_eval_trainable`) and the mode each part of the model runs in:
  fc         extractor and head in eval mode (no dropout, batch norm on its
             running statistics); the gradient stops at the features
  projector  extractor in eval mode, head in train mode
  all        both in train mode, the frozen stem's batch norm included: its
             running statistics move though its weights do not
Train views are made at `train_sz`, eval runs at `test_sz`. AdamW's eps is
the 1e-8 default here, not stage 1's. Under --mesh-model M > 1 the label
heads are split over the model axis, as in stage 2; under --finetune all
the extractor then gets every head's gradient through `copy_to_model`.
"""

from __future__ import annotations

import dataclasses

import torch

from sm3x_torch.core import prng
from sm3x_torch.models.mlc import MLCModel, Prototypes
from sm3x_torch.ops.augment import FINETUNE_AUG
from sm3x_torch.train import common, supervised
from sm3x_torch.utils.logging import StatWriter
from sm3x_torch.utils.misc import setup_logger


def _graft(model: torch.nn.Module, state: dict, logger=None) -> list:
    """Load `state` into `model` as a `strict=False` load would, and say
    what happened: every key of the model that the checkpoint lacks is
    logged as a warning and returned (a stage-2 file has no prototype
    bias); keys the model does not have are ignored; a tensor of another
    shape raises, with the key's name and both shapes."""
    own = model.state_dict()
    for k, v in state.items():
        if k in own and tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(
                f"checkpoint shape mismatch at {k}: model expects "
                f"{tuple(own[k].shape)} but the checkpoint holds "
                f"{tuple(v.shape)} — check --mlc-proj-dim/--sa-dim-ff/--arch "
                f"match the checkpointed run")
    missing = [k for k in own if k not in state]
    for k in missing:
        if logger is not None:
            logger.warning(f"Missing key in checkpoint: {k}")
    model.load_state_dict({k: v for k, v in state.items() if k in own},
                          strict=False)
    return missing


class MLCEvalTrainer(supervised.SupervisedTrainer):
    per_label_summary = True

    def __init__(self, cfg, logger=None, pretrained_state=None):
        problems = supervised.unsupported(cfg)
        if problems:
            raise ValueError("; ".join(problems))
        self.cfg = cfg
        self.device = torch.device(cfg.run.device)
        self.logger = logger or setup_logger(cfg.run.log_path,
                                             "sm3x_torch.mlc_eval")
        self.writer = StatWriter(cfg.run.log_path, cfg.run.tensorboard,
                                 cfg.run.wandb, cfg.run.proj_name,
                                 logger=self.logger)
        m = cfg.model
        ext_train = m.finetune == "all"
        head_train = m.finetune in ("projector", "all")
        if m.finetune not in ("fc", "projector", "all"):
            raise ValueError(f"unknown finetune policy {m.finetune!r}")

        # initialise from the seed on the CPU, whatever the device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(prng.fold_in(cfg.run.seed, 0))
            self.model = MLCModel(
                arch=m.arch, proj_dim=m.mlc_proj_dim, num_labels=m.num_labels,
                mlc_proj=m.mlc_proj, l2_norm=m.l2_norm, n_heads=m.num_heads,
                sa_dim_ff=m.sa_dim_ff, sa_dropout=m.sa_dropout,
                use_prototype_bias=True, num_classes=tuple(m.num_classes),
                amp=cfg.optim.amp, img_size=(cfg.train_sz, cfg.train_sz))
            self.missing_keys = []
            if pretrained_state is not None:
                self.missing_keys = _graft(self.model, pretrained_state,
                                           self.logger)
            if m.init_prototype:
                # fresh prototype heads, from the seed's stream 1
                torch.manual_seed(prng.fold_in(cfg.run.seed, 1))
                self.model.prototypes.load_state_dict(Prototypes(
                    m.mlc_proj_dim, tuple(m.num_classes), True).state_dict())
        self.model.to(self.device)
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        self.rows = common.data_axis(cfg, self.logger)
        self.split_model("labels", num_labels=m.num_labels)
        params = common.trainable_parameters(
            self.model, lambda name: common.mlc_eval_trainable(
                name, m.finetune))
        self.net = common.data_parallel(self.model, self.device)
        self.optimizer = common.make_adamw(params, cfg.optim.base_lr,
                                           cfg.optim.wd)
        self.autocast_modules = (self.model.extractor,)
        model, net = self.model, self.net

        def forward_train(d, c, generator):
            return net(d, c, extractor_train=ext_train,
                         head_train=head_train,
                         stop_extractor_grad=m.finetune != "all",
                         generator=generator)[1]

        def forward_eval(d, c):
            return model(d, c)[1]

        aug = dataclasses.replace(FINETUNE_AUG,
                                  out_size=(cfg.train_sz, cfg.train_sz))
        self.train_step, self.eval_step = supervised.make_supervised_steps(
            forward_train, forward_eval, self.optimizer,
            cfg.optim.label_weights, tuple(cfg.data.mean),
            tuple(cfg.data.std), aug, (cfg.test_sz, cfg.test_sz),
            joint_aug=cfg.data.data_name == "SevenPCBaseDataset2",
            rows=self.rows)
