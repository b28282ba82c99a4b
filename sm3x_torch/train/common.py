"""Optimizer, freeze-policy, checkpoint and process helpers shared by the
trainers (counterpart of sm3x/train/common.py).

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


def mlc_eval_trainable(name: str, finetune: str = "projector") -> bool:
    """The eval stage's freeze policies over `MLCModel`'s parameter names
    (the model is its own head: `projectors.*`, `mlc_sa.*`, `prototypes.*`
    beside `extractor.*`):
      fc        -> only the prototype heads train
      projector -> the whole head (projectors, mlc_sa, prototypes) trains
      all       -> the head and the encoders' layer1-4 train; the stem
                   (conv1, bn1) stays frozen
    """
    head = not name.startswith("extractor.")
    if finetune == "fc":
        return name.startswith("prototypes.")
    if finetune == "projector":
        return head
    if finetune == "all":
        return head or ".encoder.layer" in name
    raise ValueError(f"unknown finetune policy {finetune!r}")


def backbone_eval_trainable(name: str, finetune: str = "fc") -> bool:
    """`Baseline` under --finetune: `fc` freezes both backbones, anything
    else trains everything."""
    if finetune == "fc":
        return name.startswith("classifier.")
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
    `model`, `optimizer`, `device` and `logger`. Checkpoints are `.pth`
    files in the reference's `{"epoch", "state_dict"}` wrapper, with the
    model's keys in the layout of the exported checkpoints, the optimizer's
    state beside them, and whatever else the trainer needs to go on
    (`extra_state`). `resume` reads one back, and every `fit` loop starts
    at `start_epoch`."""

    start_epoch: int = 0
    _best = None

    def extra_state(self) -> dict:
        """What a trainer keeps beside the model and the optimizer."""
        return {}

    def restore_extra_state(self, ckpt: dict) -> None:
        pass

    def state_dict(self, epoch: int) -> dict:
        return {
            "epoch": epoch + 1,
            "state_dict": {k: v.detach().cpu()
                           for k, v in self.model.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            **self.extra_state(),
        }

    def resume(self, path=None) -> bool:
        """--resume-path: load a `checkpoint.pth` or `ckp_*.pth` this
        trainer wrote (the model strictly, the optimizer's state, the
        trainer's extras) and start the loop at its epoch. False when no
        path was given; a missing file raises."""
        from sm3x_torch.utils.checkpoint import load_checkpoint_file

        path = path or self.cfg.run.resume_path
        if not path:
            return False
        if not os.path.isfile(path):
            raise FileNotFoundError(f"cannot find checkpoint at '{path}'")
        self.logger.info(f"Re-starting from checkpoint: '{path}' ...")
        ckpt = load_checkpoint_file(path)
        self.model.load_state_dict(ckpt["state_dict"], strict=True)
        if "optimizer" in ckpt:
            self.optimizer.load_state_dict(ckpt["optimizer"])
        self.restore_extra_state(ckpt)
        self.start_epoch = int(ckpt.get("epoch", 0))
        self.logger.info(f"resumed from '{path}' (epoch {self.start_epoch})")
        return True

    def stash_best(self, epoch: int, best_val_auc: float):
        """Keep the model as it stands as the best one, as clones on the
        device: a write to disk at every improvement would stall the epoch
        loop. `write_best` persists the stash once, after the loop."""
        self._best = {
            "epoch": epoch + 1,
            "state_dict": {k: v.detach().clone()
                           for k, v in self.model.state_dict().items()},
            "best_val_auc": float(best_val_auc),
        }

    def write_best(self):
        """Rank 0 writes the stashed best model to `best_eval.pth`; nothing
        when no epoch improved."""
        best, self._best = self._best, None
        if best is None or not is_main_process():
            return
        path = os.path.join(self.cfg.run.log_path, "best_eval.pth")
        best["state_dict"] = {k: v.cpu()
                              for k, v in best["state_dict"].items()}
        torch.save(best, path)
        self.logger.info(f"wrote {path} (epoch {best['epoch']}, "
                         f"val AUC {best['best_val_auc']:.4f})")

    def warn_unconsumed_lr_schedule(self):
        """--use-lr-schedule belongs to SSL pretraining; the other stages
        say so and train at a constant lr."""
        if self.cfg.optim.use_lr_schedule:
            self.logger.warning(
                "--use-lr-schedule is only consumed by backbone_train "
                "(SSL pretraining); this stage ignores it and uses a "
                "constant lr")

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
