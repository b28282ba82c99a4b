"""Optimizer, freeze-policy and process helpers shared by the trainers
(counterpart of the parts of sm3x/train/common.py that stages 1 and 2
use).

The JAX package freezes parameters with an optimizer mask (optax
`multi_transform` with `set_to_zero` on the masked leaves): a frozen tensor
gets no update and no weight decay. Here the same policy decides which
parameters the optimizer is given at all."""

from __future__ import annotations

import math
import os

import torch


def make_adamw(params, lr: float, wd: float = 5e-2,
               eps: float = 1e-8) -> torch.optim.AdamW:
    """torch.optim.AdamW with betas (0.9, 0.999) and decoupled weight decay
    on every tensor, as the JAX package configures optax.adamw
    (sm3x/train/common.py:24-36). Stage 1 passes eps 1e-5, the other
    stages keep the 1e-8 default; the lr is constant, as in run.sh."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=eps,
                             weight_decay=wd)


def mlc_train_trainable(name: str, finetune_backbone: bool = False) -> bool:
    """Stage 2's freeze policy over the model's parameter names: the whole
    extractor is frozen unless --finetune-backbone; the head always trains
    (its prototype weights are also overwritten by k-means every epoch)."""
    if name.startswith("extractor."):
        return finetune_backbone
    return True


def trainable_parameters(model: torch.nn.Module, predicate) -> list:
    """The parameters whose names `predicate` accepts, for the optimizer;
    the others are switched off for autograd and stay as they are."""
    chosen = []
    for name, param in model.named_parameters():
        keep = bool(predicate(name))
        param.requires_grad_(keep)
        if keep:
            chosen.append(param)
    return chosen


def drain_losses(pending: list, meter, out: list) -> None:
    """Read back the deferred (loss tensor, batch size) pairs: one wait for
    the device where a read-back a step would stall every step."""
    for loss, n in pending:
        out.append(float(loss))
        meter.update(out[-1], n)
    pending.clear()


def is_main_process() -> bool:
    """Rank 0, or no process group at all."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


class CheckpointableTrainer:
    """What the trainers share around their loops; a trainer sets `cfg`,
    `model` and `optimizer`. Checkpoints are `.pth` files in the
    reference's `{"epoch", "state_dict"}` wrapper, with the model's keys in
    the layout of the exported checkpoints, and the optimizer's state
    beside them."""

    def state_dict(self, epoch: int) -> dict:
        return {
            "epoch": epoch + 1,
            "state_dict": {k: v.detach().cpu()
                           for k, v in self.model.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
        }

    def save(self, path: str, epoch: int):
        torch.save(self.state_dict(epoch), path)

    def guard_loss(self, epoch: int, loss: float):
        """--nan-guard: dump the state and stop on a non-finite epoch loss."""
        if not self.cfg.run.nan_guard or math.isfinite(loss):
            return
        path = os.path.join(self.cfg.run.log_path, "nan_dump.pth")
        if is_main_process():
            self.save(path, epoch)
        raise FloatingPointError(
            f"non-finite loss {loss} at epoch {epoch} (state: {path})")

    def epoch_checkpoint(self, epoch: int):
        """Rank 0 writes `ckp_{epoch}.pth` every `save_freq` epochs and at
        the end, and `checkpoint.pth` every `ckpt_freq` epochs."""
        cfg = self.cfg
        if not is_main_process():
            return
        if ((epoch + 1) % cfg.run.save_freq == 0
                or epoch + 1 == cfg.optim.epochs):
            self.save(os.path.join(cfg.run.log_path, f"ckp_{epoch}.pth"),
                      epoch)
        if (epoch + 1) % max(cfg.run.ckpt_freq, 1) == 0:
            self.save(os.path.join(cfg.run.log_path, "checkpoint.pth"), epoch)
