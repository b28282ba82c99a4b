"""Loss APIs of the port (counterpart of sm3x/losses/__init__.py): the
stage-1 SSL loss assembly is in `sm3x_torch.losses.ssl`; the cluster
cross-entropy of stage 2 and the per-label weighted cross-entropy of the
supervised stages are here, and NT-Xent is re-exported from
`sm3x_torch.ops.ntxent`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sm3x_torch.ops.ntxent import (  # noqa: F401
    grouped_ntxent_loss, ntxent_logits, ntxent_loss, ntxent_loss_from_logits)


def cluster_ce(logits: torch.Tensor, assignments: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """CE(pred / T, assignment) with ignore_index=-100: ignored rows are in
    neither the numerator nor the denominator, and the denominator is at
    least 1 (sm3x/losses/__init__.py:38-48)."""
    total = F.cross_entropy(logits.float() / temperature, assignments.long(),
                            ignore_index=-100, reduction="sum")
    return total / (assignments != -100).sum().clamp(min=1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch in float32; logits (B, C), integer labels
    (B,)."""
    return F.cross_entropy(logits.float(), labels.long())


def weighted_multilabel_ce(logits_list, labels: torch.Tensor,
                           label_weights) -> torch.Tensor:
    """sum_i w_i CE(logits_i, labels[:, i]) / num_labels
    (sm3x/losses/__init__.py:28-35)."""
    total = 0.0
    for i, logits in enumerate(logits_list):
        total = total + float(label_weights[i]) * cross_entropy(
            logits, labels[:, i])
    return total / len(logits_list)
