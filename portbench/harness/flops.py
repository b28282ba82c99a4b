"""The model's operations a forward pass of one image, from its published
shapes: a multiply and an add count two. Norms, activations, pooling and
softmax are left out (they are a few per element, far below the products).
"""

from __future__ import annotations


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def resnet_forward(block: str, layers, width: int, size: int) -> float:
    """Every convolution of a ResNet (torchvision v1.5: the 3x3 conv of a
    bottleneck carries the stride) at a square input of `size`."""
    macs = 0
    s = _out(size, 7, 2, 3)
    macs += s * s * width * 3 * 49
    s = _out(s, 3, 2, 1)
    grow = 4 if block == "bottleneck" else 1
    cin, planes = width, width
    for stage, n in enumerate(layers):
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            so = _out(s, 3, stride, 1)
            out = planes * grow
            if block == "bottleneck":
                macs += s * s * planes * cin           # 1x1
                macs += so * so * planes * planes * 9  # 3x3, strided
                macs += so * so * out * planes         # 1x1
            else:
                macs += so * so * planes * cin * 9
                macs += so * so * planes * planes * 9
            if i == 0 and (stride != 1 or cin != out):
                macs += so * so * out * cin            # downsample 1x1
            cin, s = out, so
        planes *= 2
    return 2.0 * macs


def vit_forward(patch: int, dim: int, depth: int, mlp_ratio: float,
                size: int) -> float:
    """Patch embedding, and a block's q, k, v and output projections, the
    two attention products and the MLP, over S = (size / patch)^2 + 1
    tokens."""
    grid = (size // patch) ** 2
    s = grid + 1
    hidden = int(dim * mlp_ratio)
    macs = grid * dim * 3 * patch * patch
    block = 4 * s * dim * dim + 2 * s * s * dim + 2 * s * dim * hidden
    return 2.0 * (macs + depth * block)


def projector_forward(dim: int, out: int) -> float:
    """A row through Linear(dim, dim) twice and Linear(dim, out)."""
    return 2.0 * (2 * dim * dim + dim * out)
