"""SSL evaluators (counterpart of sm3x/models/evaluator.py): the linear
heads live in `sm3x_torch.models.baseline` and are re-exported here;
`knn_predict` / `knn_eval` are the weighted-kNN probe: one (B, N)
similarity product, top-k, temperature-weighted class votes. The product
is plain `torch.matmul`, as the JAX package leaves it to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sm3x_torch.models.baseline import (  # noqa: F401
    LogisticRegressEvaluator,
    MultiHeadClassifier as LogisticRegressMultiHeadEvaluator,
)


def knn_predict(query: torch.Tensor, feature_bank: torch.Tensor,
                target_bank: torch.Tensor, num_classes: int, k: int = 200,
                temperature: float = 0.07) -> torch.Tensor:
    """Weighted kNN class scores. `query` (B, D) and `feature_bank` (N, D)
    are L2-normalised features, `target_bank` (N,) integer labels; returns
    (B, num_classes) scores whose argmax is the prediction."""
    sim = query @ feature_bank.T                      # (B, N) cosine
    weight, idx = torch.topk(sim, k, dim=1)           # (B, k)
    labels = target_bank.long()[idx]                  # (B, k)
    weight = torch.exp(weight / temperature)
    one_hot = F.one_hot(labels, num_classes).to(weight.dtype)
    return (one_hot * weight[..., None]).sum(dim=1)


def _unit_rows(f: torch.Tensor) -> torch.Tensor:
    return f / f.norm(dim=1, keepdim=True).clamp(min=1e-12)


@torch.no_grad()
def knn_eval(extract_fn, train_batches, val_batches, num_classes: int,
             k: int = 200, temperature: float = 0.07) -> float:
    """Top-1 weighted-kNN accuracy of an embedding function.
    `extract_fn(batch)` -> (features (B, D), labels (B,)), both tensors;
    the first iterable fills the bank, the second holds the queries."""
    feats, labs = zip(*(extract_fn(b) for b in train_batches))
    bank = _unit_rows(torch.cat(feats))
    bank_y = torch.cat(labs)
    kk = min(k, bank.shape[0])
    correct = total = 0
    for b in val_batches:
        f, y = extract_fn(b)
        scores = knn_predict(_unit_rows(f), bank, bank_y.to(f.device),
                             num_classes, kk, temperature)
        correct += int((scores.argmax(dim=1) == y.to(f.device)).sum())
        total += len(y)
    return correct / max(total, 1)
