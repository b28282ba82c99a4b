"""Backbone registry (counterpart of sm3x/models/backbones.py).

The ResNet family is ported. The ViT family of the JAX package
(sm3x/models/vit.py) is not yet: it is a stretch model of a later slice
(ROADMAP.md, "Slice E"), together with its attention kernel K3.
"""

from __future__ import annotations

from typing import Optional

from sm3x_torch.models import resnet as resnet_lib

VIT_ARCHS = ("vit_t16", "vit_s16", "vit_b16", "vit_l16")


def _unported(arch: str):
    return NotImplementedError(
        f"{arch}: the ViT backbones are not in the PyTorch port yet "
        f"(ROADMAP.md, slice E: sm3x/models/vit.py and kernel K3)")


def build_backbone(arch: str, num_classes: Optional[int] = None):
    if arch in resnet_lib.FEAT_DIMS:
        return resnet_lib.build_resnet(arch, num_classes)
    if arch in VIT_ARCHS:
        raise _unported(arch)
    raise ValueError(f"unknown backbone {arch!r}; have "
                     f"{sorted(resnet_lib.FEAT_DIMS) + list(VIT_ARCHS)}")


def feat_dim(arch: str) -> int:
    if arch in resnet_lib.FEAT_DIMS:
        return resnet_lib.FEAT_DIMS[arch]
    if arch in VIT_ARCHS:
        raise _unported(arch)
    raise ValueError(f"unknown backbone {arch!r}")
