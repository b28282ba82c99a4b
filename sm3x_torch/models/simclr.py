"""Dual-modality SimCLR models of stage 1 (counterpart of
sm3x/models/simclr.py: `SimCLRBranch` :33, `SimCLR` :74, `SimCLRSkin` :101,
`SimCLRSkinV3` :129 with `multicrop` :189, `SimCLRSkinV32` :209,
`SimCLRSkinV2` :214, `build_ssl_model` :272). `build_ssl_model` builds the
V3 family, the one --arch-version reaches; the others have no flag, as in
the JAX package.

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
from sm3x_torch.ops.ntxent import ntxent_logits


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

    def project_view(self, x: torch.Tensor) -> torch.Tensor:
        """One view through the encoder and the intra projector, as its own
        batch-norm batch (a multi-crop local view)."""
        return self.projector(self.extract(x))


class SimCLR(nn.Module):
    """Single-modality SimCLR: one branch (key prefix `branch.`); `forward`
    returns the reference-layout (logits, labels) of the two views."""

    def __init__(self, arch: str = "resnet50", proj_dim: int = 128,
                 temperature: float = 0.5, amp: bool = False,
                 remat: Union[bool, str] = False,
                 img_size: Union[int, Sequence[int]] = 224):
        super().__init__()
        self.temperature = temperature
        self.branch = SimCLRBranch(arch, proj_dim, amp, remat, img_size)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        _, z = self.branch(x1, x2)
        b = x1.shape[0]
        return ntxent_logits(z[:b], z[b:], self.temperature)

    def extract(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.branch.extract(imgs)


class TwoBranches(nn.Module):
    """A derm and a clinic branch (`derm_backbone.`, `clinic_backbone.`)."""

    def __init__(self, arch, proj_dim, amp, remat, img_size):
        super().__init__()
        self.derm_backbone = SimCLRBranch(arch, proj_dim, amp, remat, img_size)
        self.clinic_backbone = SimCLRBranch(arch, proj_dim, amp, remat,
                                            img_size)

    def extract(self, derm_imgs, clinic_imgs):
        return (self.derm_backbone.extract(derm_imgs),
                self.clinic_backbone.extract(clinic_imgs))


class SimCLRSkin(TwoBranches):
    """Two independent branches, intra-modal projections only."""

    def __init__(self, arch: str = "resnet50", proj_dim: int = 128,
                 amp: bool = False, remat: Union[bool, str] = False,
                 img_size: Union[int, Sequence[int]] = 224):
        super().__init__(arch, proj_dim, amp, remat, img_size)

    def forward(self, derm_imgs, clinic_imgs) -> dict:
        _, derm_z = self.derm_backbone(*derm_imgs)
        _, clinic_z = self.clinic_backbone(*clinic_imgs)
        return {"derm_z": derm_z, "clinic_z": clinic_z}


class SimCLRSkinV3(TwoBranches):
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
        super().__init__(arch, proj_dim, amp, remat, img_size)
        self.shared_cross_proj = shared_cross_proj
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

    def forward(self, derm_imgs, clinic_imgs, derm_locals=(),
                clinic_locals=()) -> dict:
        """With local views (multi-crop), also `derm_local_z` and
        `clinic_local_z`: one (B, P) projection a view (`multicrop`)."""
        derm_f, derm_z = self.derm_backbone(*derm_imgs)
        clinic_f, clinic_z = self.clinic_backbone(*clinic_imgs)
        out = {
            "derm_z": derm_z,
            "clinic_z": clinic_z,
            "cross_derm_z": tuple(self._cross(0, f) for f in derm_f),
            "cross_clinic_z": tuple(self._cross(1, f) for f in clinic_f),
        }
        if derm_locals or clinic_locals:
            out["derm_local_z"] = tuple(
                self.derm_backbone.project_view(v) for v in derm_locals)
            out["clinic_local_z"] = tuple(
                self.clinic_backbone.project_view(v) for v in clinic_locals)
        return out

    def multicrop(self, derm_imgs, clinic_imgs, derm_locals, clinic_locals):
        """SwAV-style multi-crop forward: the two-global-view forward, and
        each local view encoded and projected by its modality's intra
        projector as its own batch-norm batch; the loss pairs each local
        with global view 1 of its modality (sm3x_torch.losses.ssl). A train
        step calls `forward` with the locals, which is this, so that DDP
        sees the call."""
        return self(derm_imgs, clinic_imgs, derm_locals, clinic_locals)


def SimCLRSkinV32(**kw) -> SimCLRSkinV3:
    """Independent derm/clinic cross projectors."""
    return SimCLRSkinV3(shared_cross_proj=False, **kw)


FUSIONS = ("concat", "concat_cross", "concat_both", "add")


class SimCLRSkinV2(TwoBranches):
    """Fused cross contrast: `fusion` is V2 ("concat"), V21 ("concat_cross"),
    V22 ("concat_both") or V23 ("add") of the features of the two
    modalities; one cross projector (`cross_proj.`) of width 2 x feat, or
    feat for "add". Each fused pair goes through it as one 2B batch-norm
    batch; `cross_z` holds one (2B, P) projection a pair."""

    def __init__(self, arch: str = "resnet50", proj_dim: int = 128,
                 fusion: str = "concat", amp: bool = False,
                 remat: Union[bool, str] = False,
                 img_size: Union[int, Sequence[int]] = 224):
        super().__init__(arch, proj_dim, amp, remat, img_size)
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}; have {FUSIONS}")
        self.fusion = fusion
        feat = backbones.feat_dim(arch)
        self.cross_proj = SSLProjector(feat if fusion == "add" else 2 * feat,
                                       proj_dim)

    def _fuse(self, a, b):
        return a + b if self.fusion == "add" else torch.cat([a, b], dim=1)

    def forward(self, derm_imgs, clinic_imgs) -> dict:
        (d1, d2), derm_z = self.derm_backbone(*derm_imgs)
        (c1, c2), clinic_z = self.clinic_backbone(*clinic_imgs)
        same = (self._fuse(d1, c1), self._fuse(d2, c2))
        swapped = (self._fuse(d1, c2), self._fuse(d2, c1))
        pairs = {"concat": [same], "add": [same], "concat_cross": [swapped],
                 "concat_both": [same, swapped]}[self.fusion]
        return {"derm_z": derm_z, "clinic_z": clinic_z,
                "cross_z": tuple(self.cross_proj(torch.cat(p, dim=0))
                                 for p in pairs)}


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
