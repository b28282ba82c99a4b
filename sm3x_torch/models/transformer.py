"""Post-LN transformer encoder layer over the label tokens (counterpart of
sm3x/models/transformer.py: `MultiheadSelfAttention` :28,
`TransformerEncoderLayer` :70).

The MLC model mixes its 8 label tokens with one layer of torch's
`nn.TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout)`
semantics (batch_first=False, relu, norm_first=False):

    a = MHA(x, x, x)                      # dropout p on the attention weights
    x = LN1(x + Dropout(a))
    f = W2 Dropout(relu(W1 x + b1)) + b2
    x = LN2(x + Dropout(f))

Input (S, B, D). S = 8, so this is plain tensor code and no attention
kernel. The parameters carry torch's names (`self_attn.in_proj_weight`,
`self_attn.out_proj`, `linear1`, `linear2`, `norm1`, `norm2`), the layout
of the exported checkpoints. Dropout draws from a `torch.Generator` handed
to `forward`, so a step's masks follow from its seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sm3x_torch.core.mesh import current_rows


def torch_linear_init_(tensor: torch.Tensor, fan_in: int) -> torch.Tensor:
    """torch.nn.Linear's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return nn.init.uniform_(tensor, -bound, bound)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None,
            batch_dim: int = 0) -> torch.Tensor:
    """Inverted dropout with the mask drawn from `generator`. Inside
    `sm3x_torch.core.mesh.batch_rows(rows)` the mask is drawn for the
    global batch along `batch_dim` and cut to this rank's rows, so that
    every row gets the mask it gets on one process."""
    if not training or p == 0.0:
        return x
    rows = current_rows()
    if rows is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        shape = list(x.shape)
        shape[batch_dim] = rows.total
        keep = rows.take(torch.rand(shape, generator=generator,
                                    device=x.device), batch_dim)
    return x * (keep >= p).to(x.dtype) / (1.0 - p)


class MultiheadSelfAttention(nn.Module):
    """torch nn.MultiheadAttention as self-attention, batch_first=False:
    packed q/k/v projection `in_proj_weight` (3D, D), then `out_proj`."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_heads {n_heads}")
        self.n_heads, self.dropout = n_heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        torch_linear_init_(self.out_proj.weight, d_model)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        s, b, d = x.shape
        h = self.n_heads

        def heads(t):  # (S, B, D) -> (B, H, S, hd)
            return t.reshape(s, b, h, d // h).permute(1, 2, 0, 3)

        q, k, v = (heads(t) for t in F.linear(
            x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // h), -1)
        attn = dropout(attn, self.dropout, self.training, generator)
        out = (attn @ v).permute(2, 0, 1, 3).reshape(s, b, d)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int = 1,
                 dim_feedforward: int = 128, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadSelfAttention(d_model, n_heads, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        for lin, fan_in in ((self.linear1, d_model),
                            (self.linear2, dim_feedforward)):
            torch_linear_init_(lin.weight, fan_in)
            torch_linear_init_(lin.bias, fan_in)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # (S, B, D): the batch is dim 1
        drop = lambda t: dropout(t, self.dropout, self.training, generator,
                                 batch_dim=1)
        x = self.norm1(x + drop(self.self_attn(x, generator)))
        f = self.linear2(drop(torch.relu(self.linear1(x))))
        return self.norm2(x + drop(f))
