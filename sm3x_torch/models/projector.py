"""SimCLR projection head (counterpart of sm3x/models/projector.py
`SSLProjector`, :48-78).

Linear-BN-ReLU twice, then Linear-BN(affine=False); the linears have no
bias. It is an `nn.Sequential`, so its state dict keys are the reference's
`0, 1, 3, 4, 6, 7` indices (`sm3x.utils.torch_export.export_ssl_projector`).
"""

from __future__ import annotations

import math

from torch import nn

from sm3x_torch.models.layers import BatchNorm


def _linear(fan_in: int, out: int) -> nn.Linear:
    """Bias-free linear with torch.nn.Linear's U(+-1/sqrt(fan_in)) init,
    the JAX package's `torch_linear_init`."""
    lin = nn.Linear(fan_in, out, bias=False)
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(lin.weight, -bound, bound)
    return lin


class SSLProjector(nn.Sequential):
    def __init__(self, in_dim: int, proj_dim: int):
        super().__init__(
            _linear(in_dim, in_dim), BatchNorm(in_dim), nn.ReLU(inplace=True),
            _linear(in_dim, in_dim), BatchNorm(in_dim), nn.ReLU(inplace=True),
            _linear(in_dim, proj_dim), BatchNorm(proj_dim, affine=False))
