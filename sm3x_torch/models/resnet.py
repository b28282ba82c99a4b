"""ResNet family in PyTorch (counterpart of sm3x/models/resnet.py).

Torchvision v1.5 layout (the 3x3 conv of a Bottleneck carries the stride)
and torchvision's module names, so the state dict has the key layout of the
reference's checkpoints and of `sm3x.utils.torch_export.export_resnet`.

The public input is NHWC, as in the JAX package: `forward` takes
(B, H, W, 3) and views it as NCHW with `permute`, which is a channels_last
tensor without a copy. The output is the float32 pooled feature (B, C), or
logits when `num_classes` is set. Batch norm follows the JAX package's
running-variance convention (sm3x_torch.models.layers.BatchNorm); each
block's ReLUs and its residual add run in its batch norms' call
(`batch_norm_act`), which is one kernel family (K6) in train mode on the
card.

`remat=True` (bare --use-checkpoint) keeps only each residual block's input
for the backward and runs the block again there, as the JAX package remats
a block (sm3x/models/resnet.py:150-152). The second run leaves the batch-norm
running statistics alone.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sm3x_torch.models.layers import BatchNorm, batch_norm_act, recomputing


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock supports groups=1, base_width=64")
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.downsample = (nn.Sequential(_conv(inplanes, planes, 1, stride),
                                         BatchNorm(planes))
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = batch_norm_act(self.bn1, self.conv1(x))
        return batch_norm_act(self.bn2, self.conv2(out), identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = BatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = BatchNorm(width)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = BatchNorm(out)
        self.downsample = (nn.Sequential(_conv(inplanes, out, 1, stride),
                                         BatchNorm(out))
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = batch_norm_act(self.bn1, self.conv1(x))
        out = batch_norm_act(self.bn2, self.conv2(out))
        return batch_norm_act(self.bn3, self.conv3(out), identity)


class ResNet(nn.Module):
    """Stem + 4 stages + global average pool -> (B, C), at least float32."""

    def __init__(self, block, layers: Sequence[int],
                 num_classes: Optional[int] = None, groups: int = 1,
                 width_per_group: int = 64, remat: bool = False):
        super().__init__()
        self.remat = bool(remat)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, planes = 64, 64
        for stage, n_blocks in enumerate(layers):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                downsample = i == 0 and (
                    stride != 1 or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, stride, downsample,
                                    groups, width_per_group))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.feat_dim = inplanes
        self.fc = (nn.Linear(inplanes, num_classes)
                   if num_classes is not None else None)
        self.reset_parameters()

    def reset_parameters(self):
        """The JAX package's init: convs N(0, 2 / fan_out) (He, fan-out), BN
        scale 1 and bias 0, fc LeCun-normal weights and zero bias."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")
        if self.fc is not None:
            nn.init.normal_(self.fc.weight, std=1.0 / math.sqrt(
                self.fc.in_features))
            nn.init.zeros_(self.fc.bias)

    def _run_block(self, blk: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return blk(x)
        ran = []

        def run(x):
            if not ran:
                ran.append(True)
                return blk(x)
            with recomputing():  # the backward's second forward
                return blk(x)

        return checkpoint(run, x, use_reentrant=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC."""
        x = x.permute(0, 3, 1, 2)
        x = self.maxpool(batch_norm_act(self.bn1, self.conv1(x)))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for blk in stage:
                x = self._run_block(blk, x)
        x = x.mean(dim=(2, 3))
        x = x.to(torch.promote_types(x.dtype, torch.float32))  # bf16 -> f32
        if self.fc is not None:
            x = self.fc(x)
        return x


_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), {}),
    "resnet34": (BasicBlock, (3, 4, 6, 3), {}),
    "resnet50": (Bottleneck, (3, 4, 6, 3), {}),
    "resnet101": (Bottleneck, (3, 4, 23, 3), {}),
    "resnet152": (Bottleneck, (3, 8, 36, 3), {}),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3),
                        {"groups": 32, "width_per_group": 4}),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3),
                         {"groups": 32, "width_per_group": 8}),
    "resnext101_64x4d": (Bottleneck, (3, 4, 23, 3),
                         {"groups": 64, "width_per_group": 4}),
    "wide_resnet50_2": (Bottleneck, (3, 4, 6, 3), {"width_per_group": 128}),
    "wide_resnet101_2": (Bottleneck, (3, 4, 23, 3), {"width_per_group": 128}),
}

FEAT_DIMS = {arch: 512 if spec[0] is BasicBlock else 2048
             for arch, spec in _SPECS.items()}


def build_resnet(arch: str, num_classes: Optional[int] = None,
                 remat: bool = False) -> ResNet:
    block, layers, extra = _SPECS[arch]
    return ResNet(block, layers, num_classes, remat=remat, **extra)


def feat_dim(arch: str) -> int:
    return FEAT_DIMS[arch]


# torchvision-style constructors, as the reference looks an arch up by name
resnet18 = partial(build_resnet, "resnet18")
resnet34 = partial(build_resnet, "resnet34")
resnet50 = partial(build_resnet, "resnet50")
resnet101 = partial(build_resnet, "resnet101")
resnet152 = partial(build_resnet, "resnet152")
resnext50_32x4d = partial(build_resnet, "resnext50_32x4d")
resnext101_32x8d = partial(build_resnet, "resnext101_32x8d")
resnext101_64x4d = partial(build_resnet, "resnext101_64x4d")
wide_resnet50_2 = partial(build_resnet, "wide_resnet50_2")
wide_resnet101_2 = partial(build_resnet, "wide_resnet101_2")
