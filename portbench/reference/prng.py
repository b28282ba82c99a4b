"""Seed discipline, a frozen copy of the formulas the program states: a seed
folded with a value by blake2b, per-step seeds folded by epoch then step,
one `torch.Generator` a stream, and the epoch order of a split."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def fold_in(seed: int, data: int) -> int:
    digest = hashlib.blake2b(f"{seed}:{data}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def step_seed(seed: int, epoch: int, step: int) -> int:
    return fold_in(fold_in(seed, epoch), step)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The shuffled case order of one epoch."""
    idx = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(idx)
    return idx


def batch_rows(order: np.ndarray, batch: int, step: int) -> np.ndarray:
    """The cases of step `step` of an epoch: a slice of the order, the last
    one padded to a whole batch by wrapping round the order."""
    rows = order[step * batch:(step + 1) * batch]
    if len(rows) < batch:
        rows = np.concatenate([rows, np.resize(order, batch - len(rows))])
    return rows
