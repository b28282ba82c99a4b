"""Seed discipline (counterpart of sm3x/core/prng.py).

The JAX package derives every random consumer from a root key with
`fold_in`, keyed by epoch and step, so any step is reproducible on its own.
The port does the same with integer seeds: `fold_in` mixes a seed with a
value into a new 63-bit seed, and `generator` makes a fresh
`torch.Generator` on a given device from one. The numbers differ from
`jax.random`'s; the discipline is the same.
"""

from __future__ import annotations

import hashlib

import torch


def fold_in(seed: int, data: int) -> int:
    """A new seed from (seed, data), stable across processes and runs."""
    digest = hashlib.blake2b(f"{seed}:{data}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def step_seed(seed: int, epoch: int, step: int) -> int:
    """Per-step seed: fold epoch, then step."""
    return fold_in(fold_in(seed, epoch), step)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)
