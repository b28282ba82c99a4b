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
           "supervised_augment_batch", "normalize_images", "counted_kernels"]


def counted_kernels() -> tuple:
    """Every CUDA kernel wrapper (K1-K6), each counting its launches on the
    host in `launches`; K1 and K3 also count by kernel in `variants`, K3 by (B, S,
    H, D) in `shapes`."""
    from sm3x_torch.ops import attention_cuda as A
    from sm3x_torch.ops import augment_cuda as K
    from sm3x_torch.ops import batchnorm_cuda as B
    from sm3x_torch.ops import copy_cuda as C
    from sm3x_torch.ops import moe_cuda as M
    from sm3x_torch.ops import ntxent_cuda as N

    return (K.photometric_cuda, N.ntxent_forward_cuda, N.ntxent_backward_cuda,
            A.flash_forward_cuda, A.flash_backward_dq_cuda,
            A.flash_backward_dkv_cuda, C.copy_cuda, M.moe_dispatch_cuda,
            M.moe_combine_cuda, M.moe_combine_backward_cuda,
            M.moe_dispatch_backward_cuda, B.bn_forward_cuda,
            B.bn_backward_cuda)
