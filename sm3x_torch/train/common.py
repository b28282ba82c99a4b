"""Optimizer and process helpers shared by the trainers (counterpart of the
parts of sm3x/train/common.py that stage 1 uses)."""

from __future__ import annotations

import torch


def make_adamw(params, lr: float, wd: float = 5e-2,
               eps: float = 1e-8) -> torch.optim.AdamW:
    """torch.optim.AdamW with betas (0.9, 0.999) and decoupled weight decay
    on every tensor, as the JAX package configures optax.adamw
    (sm3x/train/common.py:24-36). Stage 1 passes eps 1e-5; the lr is
    constant, as in run.sh."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=eps,
                             weight_decay=wd)


def is_main_process() -> bool:
    """Rank 0, or no process group at all."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0
