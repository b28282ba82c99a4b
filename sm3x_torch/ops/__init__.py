"""The port's operators (counterpart of sm3x/ops/): NT-Xent, spherical
k-means and the batched augmentation; the CUDA kernels' wrappers are the
`*_cuda` modules, built at their first launch."""

import re

from sm3x_torch.ops.ntxent import (  # noqa: F401
    grouped_ntxent_loss, ntxent_logits, ntxent_loss)
from sm3x_torch.ops.kmeans import spherical_kmeans  # noqa: F401
from sm3x_torch.ops.augment import (  # noqa: F401
    eval_resize_batch, normalize_images, ssl_augment_batch,
    supervised_augment_batch)

__all__ = ["ntxent_loss", "ntxent_logits", "grouped_ntxent_loss",
           "spherical_kmeans", "ssl_augment_batch", "eval_resize_batch",
           "supervised_augment_batch", "normalize_images", "DEVICE_KERNELS",
           "device_launches"]

# The one count of the CUDA kernels' launches is a device trace's: each
# wrapper's kernels (K1-K6) by name among a torch.profiler profile's rows,
# and K1's two kernels and K3's two families (fma float32, mma bf16) alone
# (K3's as the benchmark's attention reader matches them).
DEVICE_KERNELS = {
    "photometric_cuda": r"photometric_(?:band|scratch)_kernel\b",
    "band": r"photometric_band_kernel\b",
    "scratch": r"photometric_scratch_kernel\b",
    "ntxent_forward_cuda": r"ntxent_fwd_kernel\b",
    "ntxent_backward_cuda": r"ntxent_bwd_kernel\b",
    "flash_forward_cuda": r"(?:^|::|\s)(?:flash_)?fwd_kernel\b",
    "flash_backward_dq_cuda": r"(?:^|::|\s)(?:flash_)?bwd_dq_kernel\b",
    "flash_backward_dkv_cuda": r"(?:^|::|\s)(?:flash_)?bwd_dkv_kernel\b",
    "fma": r"(?:^|::|\s)flash_(?:fwd|bwd_dq|bwd_dkv)_kernel\b",
    "mma": r"(?:^|::|\s)(?:fwd|bwd_dq|bwd_dkv)_kernel\b",
    "copy_cuda": r"(?:^|::|\s)copy_kernel\b",
    "moe_dispatch_cuda": r"moe_dispatch_fwd_kernel\b",
    "moe_combine_cuda": r"moe_combine_fwd_kernel\b",
    "moe_combine_backward_cuda": r"moe_combine_bwd_kernel\b",
    "moe_dispatch_backward_cuda": r"moe_dispatch_bwd_kernel\b",
    "bn_forward_cuda": r"(?:^|::)bn_fwd_\w+_kernel\b",
    "bn_backward_cuda": r"(?:^|::)bn_bwd_\w+_kernel\b",
}


def device_launches(rows) -> dict:
    """{DEVICE_KERNELS key: launches} among the device rows of a
    torch.profiler profile (`sm3x_torch.utils.timing.device_events`)."""
    return {name: sum(e.count for e in rows if re.search(rx, e.key))
            for name, rx in DEVICE_KERNELS.items()}
