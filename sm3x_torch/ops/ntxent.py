"""NT-Xent (normalized-temperature cross-entropy) contrastive loss, plain
PyTorch (counterpart of sm3x/ops/ntxent.py).

Two views' projections are concatenated to ``z = [z1; z2]`` (2B rows),
row-normalised, and ``loss_i = logsumexp_{j != i}(S_ij) - S_i,pos(i)`` with
``S = zh zh^T / T`` and ``pos(i) = (i + B) mod 2B``; the loss is the mean
over rows.

`ntxent_problems` is the batched form, over a leading problem axis
``z: (P, 2b, D)``. It is the plain twin of the forward kernel K2f
(sm3x_torch/ops/ntxent_cuda.py) and returns what the kernel saves for the
backward: the per-row logsumexp and inverse norm.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e9


def inv_norm(z: torch.Tensor) -> torch.Tensor:
    """rsqrt(max(|z|^2, 1e-24)) per row, shape (..., 1). The one definition
    of the row normalisation: it equals F.normalize's 1 / max(|z|, 1e-12)
    (sm3x/ops/ntxent.py:35-38) and the Pallas kernel's rsqrt
    (sm3x/ops/ntxent_pallas.py:40); the CUDA kernels compute the same."""
    return torch.rsqrt(torch.clamp((z * z).sum(-1, keepdim=True), min=1e-24))


def _at_least_f32(z: torch.Tensor) -> torch.Tensor:
    """bf16/f16 -> f32; f32 and f64 stay (the CPU tests run f64 too)."""
    return z.to(torch.promote_types(z.dtype, torch.float32))


def _normalize(z: torch.Tensor) -> torch.Tensor:
    return z * inv_norm(z)


def _similarity(z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """(2B, 2B) cosine similarity of the concatenated, normalised views."""
    z = _normalize(_at_least_f32(torch.cat([z1, z2], dim=0)))
    return z @ z.T


def ntxent_problems(z: torch.Tensor, temperature: float):
    """z (P, n, D), n = 2b -> (loss (P,), lse (P, n), inv (P, n))."""
    z = _at_least_f32(z)
    _, n, _ = z.shape
    inv = inv_norm(z)
    zh = z * inv
    s = torch.bmm(zh, zh.transpose(1, 2)) / temperature
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    lse = torch.logsumexp(s.masked_fill(eye, _NEG_INF), dim=2)
    pos_idx = (torch.arange(n, device=z.device) + n // 2) % n
    pos = s.gather(2, pos_idx.view(1, n, 1).expand(s.shape[0], n, 1))[..., 0]
    return (lse - pos).mean(dim=1), lse, inv[..., 0]


def ntxent_loss(z1: torch.Tensor, z2: torch.Tensor,
                temperature: float) -> torch.Tensor:
    """Mean CE over the 2B rows. z1, z2: (B, D) projections."""
    z = torch.cat([z1, z2], dim=0)[None]
    return ntxent_problems(z, temperature)[0][0]


def ntxent_logits(z1: torch.Tensor, z2: torch.Tensor, temperature: float):
    """Reference-layout logits: (2B, 2B-1) with the positive at column 0 and
    the negatives after it in increasing column order; labels all zeros."""
    b = z1.shape[0]
    n = 2 * b
    sim = _similarity(z1, z2)
    rows = torch.arange(n, device=sim.device)
    pos_idx = (rows + b) % n
    positives = sim[rows, pos_idx][:, None]
    cols = rows[None, :]
    keep = (cols != rows[:, None]) & (cols != pos_idx[:, None])
    negatives = sim[keep].view(n, n - 2)  # row-major: increasing columns
    logits = torch.cat([positives, negatives], dim=1) / temperature
    return logits, torch.zeros(n, dtype=torch.long, device=sim.device)


def group_problems(z1: torch.Tensor, z2: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """(B, D) x 2 -> (groups, 2B/groups, D): each group's [z1_g; z2_g]."""
    b, d = z1.shape
    if b % groups:
        raise ValueError(f"batch {b} not divisible by groups {groups}")
    gb = b // groups
    return torch.cat([z1.reshape(groups, gb, d), z2.reshape(groups, gb, d)],
                     dim=1)


def grouped_ntxent_loss(z1: torch.Tensor, z2: torch.Tensor,
                        temperature: float, groups: int = 1) -> torch.Tensor:
    """NT-Xent with negatives local to each of `groups` equal sub-batches
    (groups = the reference's world size reproduces DDP's per-device
    negatives), averaged over groups."""
    return ntxent_problems(group_problems(z1, z2, groups),
                           temperature)[0].mean()


def ntxent_loss_from_logits(logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of `logits` (N, C) against integer `labels` (N,)
    in at least float32: the loss of `ntxent_logits`' explicit layout."""
    logp = torch.log_softmax(_at_least_f32(logits), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()
