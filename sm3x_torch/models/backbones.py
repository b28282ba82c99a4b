"""Backbone registry: the ResNet family, the ViT family (counterpart of
sm3x/models/backbones.py) and the port's own V-MoE family
(sm3x_torch.models.vmoe), which is a ViT to every caller."""

from __future__ import annotations

from typing import Optional, Sequence, Union

from sm3x_torch.models import resnet as resnet_lib
from sm3x_torch.models import vit as vit_lib
from sm3x_torch.models import vmoe as vmoe_lib

VIT_ONLY_MODES = ("attn", "flash", "dots", "mlp", "attn_mlp")


def build_backbone(arch: str, num_classes: Optional[int] = None,
                   remat: Union[bool, str] = False,
                   img_size: Union[int, Sequence[int]] = 224):
    """`remat` is the --use-checkpoint mode; `img_size` the input size a
    ViT's pos_embed is made for (a ResNet takes any size)."""
    if arch in resnet_lib.FEAT_DIMS:
        if remat in VIT_ONLY_MODES:
            raise ValueError(
                f"--use-checkpoint={remat} is an attention-memory mode for "
                f"ViT backbones; {arch} supports bare --use-checkpoint only")
        return resnet_lib.build_resnet(arch, num_classes, remat=bool(remat))
    if arch in vit_lib.VIT_SPECS:
        return vit_lib.build_vit(arch, num_classes, remat, img_size)
    if arch in vmoe_lib.VMOE_SPECS:
        return vmoe_lib.build_vmoe(arch, num_classes, remat, img_size)
    raise ValueError(f"unknown backbone {arch!r}; have "
                     f"{sorted(resnet_lib.FEAT_DIMS) + sorted(vit_lib.VIT_SPECS) + sorted(vmoe_lib.VMOE_SPECS)}")


def feat_dim(arch: str) -> int:
    if arch in resnet_lib.FEAT_DIMS:
        return resnet_lib.FEAT_DIMS[arch]
    if arch in vit_lib.VIT_FEAT_DIMS:
        return vit_lib.VIT_FEAT_DIMS[arch]
    if arch in vmoe_lib.VMOE_SPECS:
        return vmoe_lib.VMOE_SPECS[arch]["dim"]
    raise ValueError(f"unknown backbone {arch!r}")


def is_vit(arch: str) -> bool:
    return arch in vit_lib.VIT_SPECS or arch in vmoe_lib.VMOE_SPECS
