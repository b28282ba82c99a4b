"""Spherical k-means for the DeepCluster loop (counterpart of
sm3x/ops/kmeans.py: `spherical_kmeans` :30, `scatter_assignments` :65).

The memory bank lives on the device and the whole E / M loop is matrix
products and sums there, a fixed number of iterations with no read-back.
The products go to `torch.matmul`, as the JAX package leaves them to XLA:

* init = K distinct rows (`init_idx`, else the first K of a random
  permutation drawn from `generator`);
* E-step: argmax of the dot products with the centroids;
* M-step: the mean of the assigned rows; an empty cluster keeps its
  centroid; all centroids are renormalised every iteration, with a 1e-12
  floor on the norm;
* one more E-step after the last M-step gives the assignments.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def spherical_kmeans(embeddings: torch.Tensor, k: int, iters: int = 10,
                     init_idx: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """Returns (centroids (K, D), assignments (N,) int64). Computes in
    float32, or in float64 where the embeddings are."""
    emb = embeddings.to(torch.promote_types(embeddings.dtype, torch.float32))
    if init_idx is None:
        init_idx = torch.randperm(emb.shape[0], generator=generator,
                                  device=emb.device)[:k]
    centroids = emb[torch.as_tensor(init_idx, device=emb.device)]

    def assign(c):
        return (emb @ c.T).argmax(dim=1)

    for _ in range(iters):
        one_hot = F.one_hot(assign(centroids), k).to(emb.dtype)   # (N, K)
        counts = one_hot.sum(dim=0)
        mean = (one_hot.T @ emb) / counts.clamp(min=1.0)[:, None]
        centroids = torch.where((counts > 0)[:, None], mean, centroids)
        centroids = centroids / centroids.norm(dim=1, keepdim=True).clamp(
            min=1e-12)
    return centroids, assign(centroids)


def scatter_assignments(assignments: torch.Tensor, indexes: torch.Tensor,
                        total: int) -> torch.Tensor:
    """A vector of length `total` filled with -100, with `assignments`
    written at positions `indexes`."""
    out = torch.full((total,), -100, dtype=torch.int64,
                     device=assignments.device)
    out[indexes.long()] = assignments.long()
    return out
