"""Multi-label-classification model of stage 2 and inference (counterpart
of sm3x/models/mlc.py: `Prototypes` :29, `MLCHead` :67, `_BareEncoder`
:107, `DualExtractor` :124, `MLCModel` :143).

    feats = cat(derm_encoder(derm), clinic_encoder(clinic))    # (B, 2 F)
    proj  = MultiLabelProjector(feats)                         # (H, B, P)
    sa    = TransformerEncoderLayer(proj)                      # label tokens
    preds = [prototypes[i](sa[i % len(sa)]) for i in range(8)]

The state dict is flat, the layout of the released checkpoints
(`sm3x.utils.torch_export.export_mlc_model`): `extractor.{mod}.encoder.*`,
`projectors.projectors.{h}.{idx}.*`, `mlc_sa.*`, `prototypes.{i}.*`. So
`MLCModel` is an `MLCHead` that also owns the extractor.

The JAX package passes train flags with each call; here `forward` puts the
extractor and the head into the mode the call asks for before it runs them.
With `stop_extractor_grad` the extractor runs under `torch.no_grad()`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sm3x_torch import NUM_CLASSES
from sm3x_torch.models import backbones
from sm3x_torch.models.projector import MultiLabelProjector
from sm3x_torch.models.transformer import (TransformerEncoderLayer,
                                           torch_linear_init_)


class Prototypes(nn.ModuleList):
    """One linear head a label, with the labels' own class counts.

    Train variant (DeepCluster): no bias, the weights overwritten by the
    k-means centroids every epoch. Eval variant: a bias, and N(0, 0.01)
    weights."""

    def __init__(self, feat_dim: int,
                 num_classes: Sequence[int] = tuple(NUM_CLASSES),
                 use_bias: bool = False):
        super().__init__(nn.Linear(feat_dim, c, bias=use_bias)
                         for c in num_classes)
        for head in self:
            if use_bias:
                nn.init.normal_(head.weight, std=0.01)
                nn.init.zeros_(head.bias)
            else:
                torch_linear_init_(head.weight, feat_dim)

    def forward(self, sa_feats: torch.Tensor) -> list:
        """sa_feats (H, B, D) -> list of (B, C_i)."""
        n_heads = sa_feats.shape[0]
        return [head(sa_feats[i % n_heads]) for i, head in enumerate(self)]


class MLCHead(nn.Module):
    """Projectors, transformer mixing and prototype heads on the extracted,
    concatenated features (B, in_dim)."""

    def __init__(self, in_dim: int, proj_dim: int = 512, num_labels: int = 8,
                 mlc_proj: str = "v4", l2_norm: bool = False,
                 n_heads: int = 1, sa_dim_ff: int = 128,
                 sa_dropout: float = 0.1, use_prototype_bias: bool = False,
                 num_classes: Sequence[int] = tuple(NUM_CLASSES)):
        super().__init__()
        self.l2_norm = l2_norm
        self.projectors = MultiLabelProjector(in_dim, proj_dim, num_labels,
                                              mlc_proj)
        self.mlc_sa = TransformerEncoderLayer(proj_dim, n_heads, sa_dim_ff,
                                              sa_dropout)
        self.prototypes = Prototypes(proj_dim, num_classes,
                                     use_prototype_bias)

    def forward(self, feats: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """feats (B, in_dim) -> (sa (H, B, P), preds: list of (B, C_i));
        `train` sets the head's batch-norm mode and dropout."""
        for mod in (self.projectors, self.mlc_sa, self.prototypes):
            mod.train(train)
        sa = self.mlc_sa(self.projectors(feats), generator)
        if self.l2_norm:
            sa = sa / sa.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        return sa, self.prototypes(sa)


class _BareEncoder(nn.Module):
    """One bare backbone under an `encoder` scope, which keeps the keys
    `extractor.derm_backbone.encoder.*` of the stage-1 checkpoints."""

    def __init__(self, arch: str, img_size=224):
        super().__init__()
        self.encoder = backbones.build_backbone(arch, img_size=img_size)

    def forward(self, x):
        return self.encoder(x)


class DualExtractor(nn.Module):
    """Two bare encoders; returns the concatenated (B, 2 F) late-fusion
    feature in float32. With `amp` the encoders run under bf16 autocast."""

    def __init__(self, arch: str = "resnet50", amp: bool = False,
                 img_size=224):
        super().__init__()
        self.amp = amp
        self.derm_backbone = _BareEncoder(arch, img_size)
        self.clinic_backbone = _BareEncoder(arch, img_size)
        self.feat_dim = 2 * backbones.feat_dim(arch)

    def forward(self, derm_imgs, clinic_imgs):
        with torch.autocast(derm_imgs.device.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            d = self.derm_backbone(derm_imgs)
            c = self.clinic_backbone(clinic_imgs)
        return torch.cat([d, c], dim=1).float()


class MLCModel(MLCHead):
    """The whole stage-2 / inference model: DualExtractor and MLCHead.

    `extractor_train` and `head_train` are the reference's granular
    train / eval switches: they set batch-norm's statistics mode and
    dropout. Which parameters are updated is the optimizer's business
    (sm3x_torch.train.common.trainable_parameters)."""

    def __init__(self, arch: str = "resnet50", proj_dim: int = 512,
                 num_labels: int = 8, mlc_proj: str = "v4",
                 l2_norm: bool = False, n_heads: int = 1,
                 sa_dim_ff: int = 128, sa_dropout: float = 0.1,
                 use_prototype_bias: bool = False,
                 num_classes: Sequence[int] = tuple(NUM_CLASSES),
                 amp: bool = False, img_size=224):
        super().__init__(2 * backbones.feat_dim(arch), proj_dim, num_labels,
                         mlc_proj, l2_norm, n_heads, sa_dim_ff, sa_dropout,
                         use_prototype_bias, num_classes)
        self.extractor = DualExtractor(arch, amp, img_size)

    def forward(self, derm_imgs, clinic_imgs, extractor_train: bool = False,
                head_train: bool = False, stop_extractor_grad: bool = True,
                generator: Optional[torch.Generator] = None):
        self.extractor.train(extractor_train)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not stop_extractor_grad):
            feats = self.extractor(derm_imgs, clinic_imgs)
        return MLCHead.forward(self, feats, head_train, generator)
