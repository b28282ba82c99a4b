"""Backbone linear eval (counterpart of sm3x/train/backbone_eval.py): the
two encoders of a stage-1 checkpoint go into a `Baseline` (dual backbone
and 8 linear heads); `--finetune fc` trains the heads on frozen backbones
in eval mode, with no backward through them, anything else trains the
whole model in train mode. Views are made with the probe preset at
`img_sz`; AdamW's eps is `cfg.optim.adam_eps`. Leaves `best_eval.pth` and
`results.csv`, per-label metrics in the released layout.
"""

from __future__ import annotations

import dataclasses

import torch

from sm3x_torch.core import prng
from sm3x_torch.models.baseline import Baseline
from sm3x_torch.ops.augment import PROBE_AUG
from sm3x_torch.train import common, supervised
from sm3x_torch.utils.checkpoint import MODALITIES
from sm3x_torch.utils.logging import StatWriter
from sm3x_torch.utils.misc import setup_logger


def baseline_encoder_state(encoder_state: dict) -> dict:
    """A stage-1 file's `{mod}.encoder.*` keys as `Baseline` names its bare
    backbones, `{mod}.*`."""
    out = {}
    for mod in MODALITIES:
        prefix = f"{mod}.encoder."
        out.update({f"{mod}.{k[len(prefix):]}": v
                    for k, v in encoder_state.items()
                    if k.startswith(prefix)})
    return out


class BackboneEvalTrainer(supervised.SupervisedTrainer):
    def __init__(self, cfg, logger=None, encoder_state=None):
        problems = supervised.unsupported(cfg)
        if problems:
            raise ValueError("; ".join(problems))
        self.cfg = cfg
        self.device = torch.device(cfg.run.device)
        self.logger = logger or setup_logger(cfg.run.log_path,
                                             "sm3x_torch.backbone_eval")
        self.writer = StatWriter(cfg.run.log_path, cfg.run.tensorboard,
                                 cfg.run.wandb, cfg.run.proj_name,
                                 logger=self.logger)
        m = cfg.model
        # initialise from the seed on the CPU, whatever the device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(prng.fold_in(cfg.run.seed, 0))
            self.model = Baseline(arch=m.arch,
                                  num_classes=tuple(m.num_classes),
                                  amp=cfg.optim.amp,
                                  img_size=tuple(cfg.data.img_sz))
        if encoder_state is not None:
            state = baseline_encoder_state(encoder_state)
            result = self.model.load_state_dict(state, strict=False)
            left = [k for k in result.missing_keys
                    if not k.startswith("classifier.")]
            if left or result.unexpected_keys:
                raise ValueError(f"the checkpoint's encoders do not fit "
                                 f"{m.arch}: missing {left[:5]}, unexpected "
                                 f"{result.unexpected_keys[:5]}")
        self.model.to(self.device)
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        self.rows = common.data_axis(cfg, self.logger)
        params = common.trainable_parameters(
            self.model, lambda name: common.backbone_eval_trainable(
                name, m.finetune))
        self.net = common.data_parallel(self.model, self.device)
        self.optimizer = common.make_adamw(params, cfg.optim.base_lr,
                                           cfg.optim.wd,
                                           eps=cfg.optim.adam_eps)
        self.autocast_modules = (self.model,)
        backbone_train_mode = m.finetune != "fc"
        model, net = self.model, self.net

        def forward_train(d, c, generator):
            return net(d, c, train=backbone_train_mode,
                         stop_backbone_grad=m.finetune == "fc",
                         generator=generator)

        def forward_eval(d, c):
            return model(d, c, train=False)

        aug = dataclasses.replace(PROBE_AUG, out_size=tuple(cfg.data.img_sz))
        self.train_step, self.eval_step = supervised.make_supervised_steps(
            forward_train, forward_eval, self.optimizer,
            cfg.optim.label_weights, tuple(cfg.data.mean),
            tuple(cfg.data.std), aug, tuple(cfg.data.img_sz),
            joint_aug=cfg.data.data_name == "SevenPCBaseDataset2",
            rows=self.rows)
