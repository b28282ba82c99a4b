"""The port's four stage trainers and their steps (counterpart of
sm3x/train/)."""

from sm3x_torch.train.common import make_adamw  # noqa: F401
from sm3x_torch.train.backbone_train import (  # noqa: F401
    SSLTrainer, make_ssl_train_step)
from sm3x_torch.train.mlc_train import (  # noqa: F401
    MLCTrainer, cluster_and_update, make_mlc_train_step)
from sm3x_torch.train.mlc_eval import MLCEvalTrainer  # noqa: F401
from sm3x_torch.train.backbone_eval import BackboneEvalTrainer  # noqa: F401
from sm3x_torch.train.linear_probe import (  # noqa: F401
    LinearProbe, make_ssl_extract_fn)
from sm3x_torch.train.supervised import (  # noqa: F401
    collect_eval_logits, make_supervised_steps, run_eval_epoch,
    run_train_epoch)

__all__ = [
    "make_adamw", "SSLTrainer", "make_ssl_train_step", "MLCTrainer",
    "make_mlc_train_step", "cluster_and_update", "MLCEvalTrainer",
    "BackboneEvalTrainer", "LinearProbe", "make_ssl_extract_fn",
    "make_supervised_steps", "run_train_epoch", "run_eval_epoch",
    "collect_eval_logits",
]
