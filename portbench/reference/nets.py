"""The SM3 stage-1 model and loss in plain PyTorch.

The dual encoder of SimCLR-Skin v3.2 (two branches, one a modality, each an
encoder and a 3-layer MLP projector; two cross projectors), the encoders
ResNet (He et al. 2016, torchvision's v1.5 layout) or ViT (Dosovitskiy et
al. 2021, pre-LN, the class token's feature), and NT-Xent over groups of
the batch. Module names are the port's, so that one set of weights, keyed
by name, loads into both. Batch norm normalises with the batch's mean and
biased variance; running statistics are not kept (three train-mode steps
never read them).

Every convolution and matrix product of an encoder goes through `Numerics`:
`Numerics()` is float32; `Numerics("fp8")` rounds each product's two
operands to float8 e4m3 and its output's gradient to e5m2 (per-tensor
scales), the arithmetic of fp8 training, one step below bf16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """`x` rounded to an fp8 `dtype` and back, under a per-tensor scale
    that puts its largest magnitude at the format's largest."""
    scale = _FP8[dtype] / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _OutputGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, fwd, bwd):
        ctx.bwd = bwd
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


FORMATS = {"fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}


class Numerics:
    """The products' arithmetic: float32 (`None`), or each product's
    operands rounded to the format's forward type and its output's
    gradient to its backward type (`"fp8"`: e4m3 / e5m2)."""

    def __init__(self, fmt=None):
        self.fmt = FORMATS[fmt] if fmt else None

    def product(self, fn, x, w, *args, **kw):
        if self.fmt is None:
            return fn(x, w, *args, **kw)
        return _OutputGrad.apply(fn(_Operand.apply(x, *self.fmt),
                                    _Operand.apply(w, *self.fmt),
                                    *args, **kw), *self.fmt)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=None, bias=False):
        super().__init__()
        self.stride, self.padding = stride, k // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.num = Numerics()

    def forward(self, x):
        y = self.num.product(F.conv2d, x, self.weight, None, self.stride,
                             self.padding)
        return y if self.bias is None else y + self.bias[:, None, None]


class Linear(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.num = Numerics()

    def forward(self, x):
        y = self.num.product(F.linear, x, self.weight)
        return y if self.bias is None else y + self.bias


class BatchNorm(nn.Module):
    def __init__(self, c, affine=True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c)) if affine else None
        self.bias = nn.Parameter(torch.zeros(c)) if affine else None

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            1e-5)


class LayerNorm(nn.Module):
    def __init__(self, c, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


def set_numerics(model: nn.Module, numerics: Numerics) -> None:
    """Every product of `model` (its convolutions, linears and attention
    products) in `numerics`."""
    for m in model.modules():
        if hasattr(m, "num"):
            m.num = numerics


# --------------------------------------------------------------------- ResNet

class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, down):
        super().__init__()
        out = 4 * planes
        self.conv1, self.bn1 = Conv(cin, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3, stride), BatchNorm(planes)
        self.conv3, self.bn3 = Conv(planes, out, 1), BatchNorm(out)
        self.downsample = (nn.Sequential(Conv(cin, out, 1, stride),
                                         BatchNorm(out)) if down else None)

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + idt)


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride, down):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, planes, 3, stride), BatchNorm(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3), BatchNorm(planes)
        self.downsample = (nn.Sequential(Conv(cin, planes, 1, stride),
                                         BatchNorm(planes)) if down else None)

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + idt)


class ResNet(nn.Module):
    """Stem (7x7/2 conv, BN, ReLU, 3x3/2 max pool), four stages and a global
    average pool; NHWC input, (B, C) float32 features."""

    def __init__(self, block: str, layers, width: int = 64):
        super().__init__()
        blk = Bottleneck if block == "bottleneck" else BasicBlock
        grow = 4 if blk is Bottleneck else 1
        self.conv1, self.bn1 = Conv(3, width, 7, 2, 3), BatchNorm(width)
        cin, planes = width, width
        for s, n in enumerate(layers):
            blocks = []
            for i in range(n):
                stride = 2 if s > 0 and i == 0 else 1
                down = i == 0 and (stride != 1 or cin != planes * grow)
                blocks.append(blk(cin, planes, stride, down))
                cin = planes * grow
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.feat_dim = cin

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for s in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = s(x)
        return x.mean(dim=(2, 3))


# ------------------------------------------------------------------------ ViT

class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.query, self.key = Linear(dim, dim), Linear(dim, dim)
        self.value, self.out = Linear(dim, dim), Linear(dim, dim)
        self.num = Numerics()

    def forward(self, x):
        b, s, d = x.shape
        shape = (b, s, self.heads, d // self.heads)
        q, k, v = (f(x).view(shape).transpose(1, 2)
                   for f in (self.query, self.key, self.value))
        att = self.num.product(torch.matmul, q, k.transpose(2, 3))
        p = torch.softmax(att / math.sqrt(d // self.heads), dim=-1)
        o = self.num.product(torch.matmul, p, v)
        return self.out(o.transpose(1, 2).reshape(b, s, d))


class Block(nn.Module):
    def __init__(self, dim, heads, hidden, eps):
        super().__init__()
        self.ln1, self.attn = LayerNorm(dim, eps), Attention(dim, heads)
        self.ln2 = LayerNorm(dim, eps)
        self.fc1, self.fc2 = Linear(dim, hidden), Linear(hidden, dim)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class ViT(nn.Module):
    """Patch embedding, class token and position embedding, pre-LN blocks,
    the final LayerNorm's class-token row; NHWC input."""

    def __init__(self, patch, dim, depth, heads, mlp_ratio, img, eps):
        super().__init__()
        self.depth = depth
        self.patch_embed = Conv(3, dim, patch, patch, 0, bias=True)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (img // patch) ** 2 + 1,
                                                  dim))
        for i in range(depth):
            self.add_module(f"block{i}",
                            Block(dim, heads, int(dim * mlp_ratio), eps))
        self.ln_final = LayerNorm(dim, eps)
        self.feat_dim = dim

    def forward(self, x):
        x = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls.expand(x.shape[0], 1, -1), x], dim=1)
        x = x + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.ln_final(x)[:, 0]


# ------------------------------------------------------------------ SSL model

def projector(dim: int, out: int) -> nn.Sequential:
    """Linear-BN-ReLU twice, then Linear-BN without affine; no biases."""
    return nn.Sequential(Linear(dim, dim, False), BatchNorm(dim), nn.ReLU(),
                         Linear(dim, dim, False), BatchNorm(dim), nn.ReLU(),
                         Linear(dim, out, False), BatchNorm(out, False))


class Branch(nn.Module):
    def __init__(self, encoder, proj_dim):
        super().__init__()
        self.encoder = encoder
        self.projector = projector(encoder.feat_dim, proj_dim)


class DualEncoder(nn.Module):
    """SimCLR-Skin v3.2: a branch a modality, a cross projector a modality."""

    def __init__(self, make_encoder, proj_dim):
        super().__init__()
        self.derm_backbone = Branch(make_encoder(), proj_dim)
        self.clinic_backbone = Branch(make_encoder(), proj_dim)
        feat = self.derm_backbone.encoder.feat_dim
        self.cross_proj = nn.ModuleList([projector(feat, proj_dim),
                                         projector(feat, proj_dim)])

    def encoders(self):
        return [self.derm_backbone.encoder, self.clinic_backbone.encoder]

    def forward(self, derm_views, clinic_views):
        """The projections of the v3.2 loss: each view its own encoder and
        batch-norm batch; the intra projector over both views together; a
        cross projection a view."""
        out = {}
        for name, br, views, k in (("derm", self.derm_backbone, derm_views, 0),
                                   ("clinic", self.clinic_backbone,
                                    clinic_views, 1)):
            f = [br.encoder(v) for v in views]
            out[f"{name}_z"] = br.projector(torch.cat(f))
            out[f"cross_{name}_z"] = [self.cross_proj[k](x) for x in f]
        return out


def ntxent(z1, z2, temperature: float, groups: int) -> torch.Tensor:
    """NT-Xent of a pair of views, negatives within each of `groups` equal
    parts of the batch, the mean over the 2b rows of a group and over the
    groups."""
    b, d = z1.shape
    z = torch.cat([z1.reshape(groups, b // groups, d),
                   z2.reshape(groups, b // groups, d)], dim=1)
    z = z * torch.rsqrt(torch.clamp((z * z).sum(-1, keepdim=True), min=1e-24))
    n = z.shape[1]
    s = torch.bmm(z, z.transpose(1, 2)) / temperature
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    lse = torch.logsumexp(s.masked_fill(eye, -1e9), dim=2)
    pos = (torch.arange(n, device=z.device) + n // 2) % n
    positive = s.gather(2, pos.view(1, n, 1).expand(groups, n, 1))[..., 0]
    return (lse - positive).mean()


def ssl_loss(out: dict, temperature: float, groups: int) -> torch.Tensor:
    """v3.2: L(derm views) + L(clinic views) + the mean of the two cross
    terms (derm view i against clinic view i)."""
    b = out["derm_z"].shape[0] // 2
    total = (ntxent(out["derm_z"][:b], out["derm_z"][b:], temperature, groups)
             + ntxent(out["clinic_z"][:b], out["clinic_z"][b:], temperature,
                      groups))
    for cd, cc in zip(out["cross_derm_z"], out["cross_clinic_z"]):
        total = total + 0.5 * ntxent(cd, cc, temperature, groups)
    return total
