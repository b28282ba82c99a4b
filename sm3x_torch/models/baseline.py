"""Supervised baselines and linear evaluators (counterpart of
sm3x/models/baseline.py: `MultiHeadClassifier` :28,
`LogisticRegressEvaluator` :41, `MLPHead` :52, `Baseline` :80,
`SingleBaseline` :133).

Every head is N(0, 0.01) weights and a zero bias. The state dict is flat:
`derm_backbone.*` and `clinic_backbone.*` hold bare backbones (a stage-1
checkpoint's `{mod}.encoder.*` with `encoder.` dropped), and
`classifier.{i}.weight / bias` the eight linear heads, the layout
`sm3x.utils.torch_convert.convert_multihead_classifier` reads; the MLP
variants keep `classifier.{i}.fc1`, `.bn` and `.fc2`.

As in `sm3x_torch.models.mlc`, `forward` puts the module into the mode the
call asks for (`train`: batch statistics and dropout) before it runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sm3x_torch import NUM_CLASSES
from sm3x_torch.models import backbones
from sm3x_torch.models.layers import BatchNorm
from sm3x_torch.models.transformer import dropout


def _head_linear(in_dim: int, out_dim: int) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim)
    nn.init.normal_(lin.weight, std=0.01)
    nn.init.zeros_(lin.bias)
    return lin


class MultiHeadClassifier(nn.ModuleList):
    """One linear head a label on a shared feature: (B, F) -> list of
    (B, C_i)."""

    def __init__(self, in_dim: int,
                 num_classes: Sequence[int] = tuple(NUM_CLASSES)):
        super().__init__(_head_linear(in_dim, c) for c in num_classes)

    def forward(self, x: torch.Tensor) -> list:
        return [head(x) for head in self]


class LogisticRegressEvaluator(nn.Module):
    """A single linear probe head."""

    def __init__(self, in_dim: int, n_classes: int):
        super().__init__()
        self.classifier = _head_linear(in_dim, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(x)


class MLPHead(nn.Module):
    """Linear-ReLU-Linear (variant 1), with Dropout(0.5) (variant 2) or
    batch norm (variant 3) after the ReLU."""

    def __init__(self, in_dim: int, n_classes: int, variant: int = 1,
                 hidden: int = 512):
        super().__init__()
        if variant not in (1, 2, 3):
            raise ValueError(f"unknown MLP head variant {variant!r}")
        self.variant = variant
        self.fc1 = _head_linear(in_dim, hidden)
        if variant == 3:
            self.bn = BatchNorm(hidden)
        self.fc2 = _head_linear(hidden, n_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.fc1(x))
        if self.variant == 2:
            x = dropout(x, 0.5, self.training, generator)
        elif self.variant == 3:
            x = self.bn(x)
        return self.fc2(x)


def _refuse_timm(arch: str) -> None:
    if arch.startswith("timm"):
        from sm3x_torch.models.resnet import FEAT_DIMS
        from sm3x_torch.models.vit import VIT_FEAT_DIMS

        raise ValueError(
            f"timm arch {arch!r} is not available in this build; "
            f"use one of {sorted(FEAT_DIMS) + sorted(VIT_FEAT_DIMS)}")


class Baseline(nn.Module):
    """Two backbones and eight heads on their concatenated features.
    `mlp_variant` None: linear heads; 1 / 2 / 3: `MLPHead`s. With `amp`
    the backbones run under bf16 autocast; the heads stay float32."""

    def __init__(self, arch: str = "resnet50",
                 num_classes: Sequence[int] = tuple(NUM_CLASSES),
                 mlp_variant: Optional[int] = None, amp: bool = False,
                 img_size=224):
        super().__init__()
        _refuse_timm(arch)
        self.amp = amp
        self.mlp_variant = mlp_variant
        self.derm_backbone = backbones.build_backbone(arch, img_size=img_size)
        self.clinic_backbone = backbones.build_backbone(arch,
                                                        img_size=img_size)
        self.feat_dim = 2 * backbones.feat_dim(arch)
        if mlp_variant is None:
            self.classifier = MultiHeadClassifier(self.feat_dim, num_classes)
        else:
            self.classifier = nn.ModuleList(
                MLPHead(self.feat_dim, c, mlp_variant) for c in num_classes)

    def extract(self, derm_imgs, clinic_imgs, train: bool = False):
        """The two float32 features (B, F) each."""
        self.derm_backbone.train(train)
        self.clinic_backbone.train(train)
        with torch.autocast(derm_imgs.device.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            d = self.derm_backbone(derm_imgs)
            c = self.clinic_backbone(clinic_imgs)
        return d.float(), c.float()

    def forward(self, derm_imgs, clinic_imgs, train: bool = False,
                stop_backbone_grad: bool = False,
                generator: Optional[torch.Generator] = None) -> list:
        """`stop_backbone_grad` runs the backbones without a graph, so a
        frozen-backbone policy pays for no backward through them."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not stop_backbone_grad):
            feats = torch.cat(self.extract(derm_imgs, clinic_imgs, train),
                              dim=1)
        self.classifier.train(train)
        if self.mlp_variant is None:
            return self.classifier(feats)
        return [head(feats, generator) for head in self.classifier]


class SingleBaseline(nn.Module):
    """One backbone and eight linear heads."""

    def __init__(self, arch: str = "resnet50",
                 num_classes: Sequence[int] = tuple(NUM_CLASSES),
                 amp: bool = False, img_size=224):
        super().__init__()
        self.amp = amp
        self.derm_backbone = backbones.build_backbone(arch, img_size=img_size)
        self.classifier = MultiHeadClassifier(backbones.feat_dim(arch),
                                              num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> list:
        self.train(train)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            feats = self.derm_backbone(x)
        return self.classifier(feats.float())
