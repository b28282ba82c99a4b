"""The port's operators (counterpart of sm3x/ops/): NT-Xent, spherical
k-means and the batched augmentation; the CUDA kernels' wrappers are the
`*_cuda` modules, built at their first launch."""

from sm3x_torch.ops.ntxent import (  # noqa: F401
    grouped_ntxent_loss, ntxent_logits, ntxent_loss)
from sm3x_torch.ops.kmeans import spherical_kmeans  # noqa: F401
from sm3x_torch.ops.augment import (  # noqa: F401
    eval_resize_batch, normalize_images, ssl_augment_batch,
    supervised_augment_batch)

__all__ = ["ntxent_loss", "ntxent_logits", "grouped_ntxent_loss",
           "spherical_kmeans", "ssl_augment_batch", "eval_resize_batch",
           "supervised_augment_batch", "normalize_images"]
