"""Loss APIs of the port (counterpart of sm3x/losses/__init__.py): the
stage-1 SSL loss assembly is in `sm3x_torch.losses.ssl`; the cluster
cross-entropy of stage 2 is here."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cluster_ce(logits: torch.Tensor, assignments: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """CE(pred / T, assignment) with ignore_index=-100: ignored rows are in
    neither the numerator nor the denominator, and the denominator is at
    least 1 (sm3x/losses/__init__.py:38-48)."""
    total = F.cross_entropy(logits.float() / temperature, assignments.long(),
                            ignore_index=-100, reduction="sum")
    return total / (assignments != -100).sum().clamp(min=1)
