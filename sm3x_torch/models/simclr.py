"""Dual-modality SimCLR models of stage 1 (counterpart of
sm3x/models/simclr.py: `SimCLRBranch` :33, `SimCLRSkinV3` :129,
`SimCLRSkinV32` :209, `build_ssl_model` :272).

The models return projections; the NT-Xent terms are assembled in
sm3x_torch.losses.ssl. Batch-norm batching is the JAX package's: each
encoder view is its own BN batch, the intra-modal projector sees the two
views concatenated (2B), and the cross projectors see each view on its own.

Precision: with `amp` the encoders run under bf16 `torch.autocast` and
return float32 features; the projectors and everything after them stay
float32, as the JAX package builds its projectors with float32 compute.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from sm3x_torch.models import backbones
from sm3x_torch.models.projector import SSLProjector


class SimCLRBranch(nn.Module):
    """One modality: ResNet or ViT encoder + 3-layer MLP projector.
    `remat` is the encoder's --use-checkpoint mode and `img_size` the input
    size a ViT's pos_embed is made for."""

    def __init__(self, arch: str = "resnet50", proj_dim: int = 128,
                 amp: bool = False, remat: Union[bool, str] = False,
                 img_size: Union[int, Sequence[int]] = 224):
        super().__init__()
        self.amp = amp
        self.encoder = backbones.build_backbone(arch, remat=remat,
                                                img_size=img_size)
        self.encoder_out_dim = backbones.feat_dim(arch)
        self.projector = SSLProjector(self.encoder_out_dim, proj_dim)

    def extract(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            return self.encoder(x)  # float32 features under autocast too

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        """Returns ((f1, f2), z) with z = projector(cat(f1, f2)): (2B, P).
        The two views are separate encoder passes: separate BN batches."""
        f1 = self.extract(x1)
        f2 = self.extract(x2)
        return (f1, f2), self.projector(torch.cat([f1, f2], dim=0))


class SimCLRSkinV3(nn.Module):
    """Cross-modal contrast. `shared_cross_proj=True` is V3 (one cross
    projector, key prefix `cross_proj.`); False is V32 (a derm and a clinic
    cross projector, `cross_proj.0.` and `cross_proj.1.`).

    Output dict:
      derm_z / clinic_z   (2B, P) intra-modal projections
      cross_derm_z        ((B, P), (B, P)) cross projections of derm f1, f2
      cross_clinic_z      ((B, P), (B, P)) cross projections of clinic f1, f2
    """

    def __init__(self, arch: str = "resnet50", proj_dim: int = 128,
                 amp: bool = False, shared_cross_proj: bool = True,
                 remat: Union[bool, str] = False,
                 img_size: Union[int, Sequence[int]] = 224):
        super().__init__()
        self.shared_cross_proj = shared_cross_proj
        self.derm_backbone = SimCLRBranch(arch, proj_dim, amp, remat, img_size)
        self.clinic_backbone = SimCLRBranch(arch, proj_dim, amp, remat,
                                            img_size)
        feat = backbones.feat_dim(arch)
        if shared_cross_proj:
            self.cross_proj = SSLProjector(feat, proj_dim)
        else:
            self.cross_proj = nn.ModuleList(
                [SSLProjector(feat, proj_dim), SSLProjector(feat, proj_dim)])

    def _cross(self, which: int, f: torch.Tensor) -> torch.Tensor:
        proj = self.cross_proj if self.shared_cross_proj else self.cross_proj[
            which]
        return proj(f)

    def forward(self, derm_imgs, clinic_imgs) -> dict:
        derm_f, derm_z = self.derm_backbone(*derm_imgs)
        clinic_f, clinic_z = self.clinic_backbone(*clinic_imgs)
        return {
            "derm_z": derm_z,
            "clinic_z": clinic_z,
            "cross_derm_z": tuple(self._cross(0, f) for f in derm_f),
            "cross_clinic_z": tuple(self._cross(1, f) for f in clinic_f),
        }

    def extract(self, derm_imgs, clinic_imgs):
        return (self.derm_backbone.extract(derm_imgs),
                self.clinic_backbone.extract(clinic_imgs))


def SimCLRSkinV32(**kw) -> SimCLRSkinV3:
    """Independent derm/clinic cross projectors."""
    return SimCLRSkinV3(shared_cross_proj=False, **kw)


_VERSIONS = {
    "v3": (True, 0), "v311": (True, 1), "v312": (True, 2),
    "v32": (False, 0), "v321": (False, 1), "v322": (False, 2),
}


def build_ssl_model(arch_version: str, arch: str = "resnet50",
                    proj_dim: int = 128, amp: bool = False,
                    remat: Union[bool, str] = False,
                    img_size: Union[int, Sequence[int]] = 224
                    ) -> Tuple[SimCLRSkinV3, int]:
    """--arch-version -> (model, loss style)."""
    if arch_version not in _VERSIONS:
        raise ValueError(f"unknown arch_version {arch_version!r}; the port "
                         f"has {sorted(_VERSIONS)}")
    shared, style = _VERSIONS[arch_version]
    return SimCLRSkinV3(arch, proj_dim, amp, shared, remat, img_size), style
