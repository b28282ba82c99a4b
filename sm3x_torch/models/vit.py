"""Vision Transformer backbones (counterpart of sm3x/models/vit.py:97-262).

Pre-LN ViT: patch embed -> [cls] + pos embed -> depth x (LN-MHA-add,
LN-MLP(gelu)-add) -> final LN -> the cls token's feature, at least
float32 (bf16 under autocast -> float32). The
input is NHWC (B, H, W, 3), as in the JAX package.

Module names follow the Flax tree (`patch_embed`, `cls`, `pos_embed`,
`block{i}.ln1`, `block{i}.attn.{query,key,value,out}`, `block{i}.ln2`,
`block{i}.fc1`, `block{i}.fc2`, `ln_final`), so that
`sm3x_torch.utils.weights.vit_state_dict` maps a Flax tree mechanically.
The JAX package's numerics are kept: LayerNorm eps 1e-6, gelu with the
tanh approximation (Flax `nn.gelu`), Flax's initialisers.

Activation-memory modes (`remat`, the JAX package's ladder; the weights are
the same in every mode):
  False          autograd saves everything (the trainer maps "off" here)
  True           torch.utils.checkpoint around each block
  "dots"         each block under a selective checkpoint that saves the
                 outputs of the weight matmuls (aten.mm / addmm) and
                 recomputes the rest: jax.checkpoint_policies.
                 dots_with_no_batch_dims_saveable
  "attn"         checkpoint around the attention only
  "flash"        FlashAttention: kernels K3f / K3b-dq / K3b-dkv on the card
  "mlp"          checkpoint around ln2 + fc1 + gelu
  "attn_mlp"     "attn" and "mlp"

`pos_embed` is made for the grid of `img_size` and resized bilinearly for
another grid (`ViT.pos_embed_for`).

Tensor parallelism (--mesh-model > 1, sm3x_torch.parallel.tensor): each
`ViTBlock` is split Megatron style by `split_for_model`, after the whole
model was built from the seed, as sm3x_torch.core.mesh.vit_tp_shardings
says: a rank keeps the q/k/v rows and bias of its H / M heads and the
`out` columns of those heads, the `fc1` rows and bias of its share of the
hidden units and the `fc2` columns. The inputs of q/k/v and of `fc1` enter
through `copy_to_model`; the partial outputs of `out` and `fc2` are summed
by `reduce_from_model`, their whole biases added once after the sum.
Heads that the model axis does not divide keep the attention whole on
every rank, and the MLP still splits.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sm3x_torch.ops.attention import ATTENTION_FNS
from sm3x_torch.parallel.tensor import copy_to_model, reduce_from_model

LN_EPS = 1e-6
REMAT_MODES = (False, True, "dots", "attn", "flash", "mlp", "attn_mlp")


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Flax's `lecun_normal`: a normal truncated at two of its standard
    deviations, rescaled so that the result has variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def torch_linear_init_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """The JAX package's `torch_linear_init`: U(-1/sqrt(fan_in), +)."""
    bound = 1.0 / math.sqrt(fan_in)
    return nn.init.uniform_(w, -bound, bound)


def _linear(fan_in: int, out: int, init) -> nn.Linear:
    lin = nn.Linear(fan_in, out)
    init(lin.weight, fan_in)
    nn.init.zeros_(lin.bias)
    return lin


def _keep(lin: nn.Linear, dim: int, size: int, index: int) -> None:
    """`lin` cut to block `index` of `size` of its weight's `dim` (0: output
    rows, with the bias; 1: input columns, the bias whole)."""
    n = lin.weight.shape[dim] // size
    lin.weight = nn.Parameter(
        lin.weight.detach().narrow(dim, index * n, n).clone())
    if dim == 0:
        lin.bias = nn.Parameter(
            lin.bias.detach().narrow(0, index * n, n).clone())
        lin.out_features = n
    else:
        lin.in_features = n


def _row_parallel(lin: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel `lin` on this rank's columns of its input: the partial
    products summed over the model group in float32, the bias added once,
    one cast to the products' dtype."""
    part = F.linear(x, lin.weight)
    return (reduce_from_model(part, group) + lin.bias).to(part.dtype)


class MultiHeadAttention(nn.Module):
    """Flax `MultiHeadDotProductAttention` (self-attention, no mask): the
    q/k/v projections to (B, S, H, D), an attention function of the mode
    table, and the output projection."""

    def __init__(self, dim: int, n_heads: int, attn_impl: str = "xla"):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} is not a multiple of {n_heads} heads")
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.attn_fn = ATTENTION_FNS[attn_impl]
        self.query = _linear(dim, dim, lecun_normal_)
        self.key = _linear(dim, dim, lecun_normal_)
        self.value = _linear(dim, dim, lecun_normal_)
        self.out = _linear(dim, dim, lecun_normal_)
        self.group = None   # the model group once the heads are split

    def split_for_model(self, size: int, index: int, group) -> bool:
        """Keep heads [index H / size, (index + 1) H / size); False (and the
        attention whole) where `size` does not divide the heads."""
        if self.n_heads % size:
            return False
        for lin in (self.query, self.key, self.value):
            _keep(lin, 0, size, index)
        _keep(self.out, 1, size, index)
        self.n_heads //= size
        self.group = group
        return True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        if self.group is not None:
            x = copy_to_model(x, self.group)
        shape = (b, s, self.n_heads, self.head_dim)
        o = self.attn_fn(self.query(x).view(shape), self.key(x).view(shape),
                         self.value(x).view(shape))
        o = o.reshape(b, s, self.n_heads * self.head_dim)
        if self.group is None:
            return self.out(o)
        return _row_parallel(self.out, o, self.group)


class ViTBlock(nn.Module):
    tp_kind = "vit"   # sm3x_torch.parallel.tensor.tensor_parallel

    def __init__(self, dim: int, n_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "xla", mlp_remat: bool = False):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.mlp_remat = mlp_remat
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, n_heads, attn_impl)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = _linear(dim, hidden, torch_linear_init_)
        self.fc2 = _linear(hidden, dim, torch_linear_init_)
        self.group = None   # the model group once the MLP is split

    def split_for_model(self, size: int, index: int, group) -> None:
        """Split the attention's heads and the MLP's hidden units over a
        model axis of `size`, this rank holding block `index`; each part
        stays whole where `size` does not divide it."""
        self.attn.split_for_model(size, index, group)
        if self.fc1.out_features % size == 0:
            _keep(self.fc1, 0, size, index)
            _keep(self.fc2, 1, size, index)
            self.group = group

    def mlp_in(self, x: torch.Tensor) -> torch.Tensor:
        """ln2 + fc1 + gelu, the span that "mlp" recomputes."""
        h = self.ln2(x)
        if self.group is not None:
            h = copy_to_model(h, self.group)
        return F.gelu(self.fc1(h), approximate="tanh")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        if self.mlp_remat and torch.is_grad_enabled():
            h = checkpoint(self.mlp_in, x, use_reentrant=False)
        else:
            h = self.mlp_in(x)
        if self.group is None:
            return x + self.fc2(h)
        return x + _row_parallel(self.fc2, h, self.group)


def _dots_saveable_context():
    """Selective checkpoint that saves the weight matmuls' outputs."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def _grid(img_size, patch: int):
    hw = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
    return hw[0] // patch, hw[1] // patch


class ViT(nn.Module):
    def __init__(self, patch: int = 16, dim: int = 768, depth: int = 12,
                 n_heads: int = 12, mlp_ratio: float = 4.0,
                 num_classes: Optional[int] = None,
                 remat: Union[bool, str] = False,
                 img_size: Union[int, Sequence[int]] = 224):
        super().__init__()
        if not (isinstance(remat, bool) or remat in REMAT_MODES[2:]):
            # a typo ('flsh') must not run some other mode
            raise ValueError(
                f"unknown remat/--use-checkpoint mode {remat!r}; valid: "
                f"False, True, 'dots', 'attn', 'flash', 'mlp', 'attn_mlp'")
        self.patch, self.dim, self.depth = patch, dim, depth
        self.remat = remat
        attn_impl = remat if remat in ("attn", "flash") else (
            "attn" if remat == "attn_mlp" else "xla")
        self.attn_impl = attn_impl
        mlp_remat = remat in ("mlp", "attn_mlp")
        self.block_remat = remat in (True, "dots")

        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        lecun_normal_(self.patch_embed.weight, 3 * patch * patch)
        nn.init.zeros_(self.patch_embed.bias)
        self.grid = _grid(img_size, patch)
        self.cls = nn.Parameter(torch.randn(1, 1, dim) * 0.02)
        self.pos_embed = nn.Parameter(
            torch.randn(1, self.grid[0] * self.grid[1] + 1, dim) * 0.02)
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, n_heads, mlp_ratio,
                                                  attn_impl, mlp_remat))
        self.ln_final = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc = nn.Linear(dim, num_classes) if num_classes else None
        if self.fc is not None:
            lecun_normal_(self.fc.weight, dim)
            nn.init.zeros_(self.fc.bias)

    def pos_embed_for(self, grid) -> torch.Tensor:
        """`pos_embed` on a (gh, gw) patch grid: as stored on the grid it was
        made for, else its grid part resized bilinearly with half-pixel
        centres, antialiased where it shrinks, the class token's row kept
        (`jax.image.resize(..., "bilinear")` in sm3x/models/vit.py:197-211)."""
        if tuple(grid) == self.grid:
            return self.pos_embed
        h0, w0 = self.grid
        pos = self.pos_embed[:, 1:].reshape(1, h0, w0, self.dim)
        pos = F.interpolate(pos.permute(0, 3, 1, 2), size=tuple(grid),
                            mode="bilinear", align_corners=False,
                            antialias=True)
        pos = pos.permute(0, 2, 3, 1).reshape(1, grid[0] * grid[1], self.dim)
        return torch.cat([self.pos_embed[:, :1], pos], dim=1)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    def _run_block(self, blk: ViTBlock, x: torch.Tensor, *args):
        if not (self.block_remat and torch.is_grad_enabled()):
            return blk(x, *args)
        if self.remat == "dots":
            return checkpoint(blk, x, *args, use_reentrant=False,
                              context_fn=_dots_saveable_context)
        return checkpoint(blk, x, *args, use_reentrant=False)

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks over the (B, S, dim) tokens."""
        for blk in self.blocks():
            x = self._run_block(blk, x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.patch_embed(x.permute(0, 3, 1, 2))  # NHWC in, NCHW view
        grid = tuple(x.shape[2:])
        x = x.flatten(2).transpose(1, 2)  # (B, gh * gw, dim), row-major grid
        cls = self.cls.expand(b, 1, self.dim).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed_for(grid).to(x.dtype)
        x = self.run_blocks(x)
        feat = self.ln_final(x)[:, 0]
        feat = feat.to(torch.promote_types(feat.dtype, torch.float32))
        return self.fc(feat) if self.fc is not None else feat


VIT_SPECS = {
    "vit_t16": dict(patch=16, dim=192, depth=12, n_heads=3),
    "vit_s16": dict(patch=16, dim=384, depth=12, n_heads=6),
    "vit_b16": dict(patch=16, dim=768, depth=12, n_heads=12),
    "vit_l16": dict(patch=16, dim=1024, depth=24, n_heads=16),
}

VIT_FEAT_DIMS = {k: v["dim"] for k, v in VIT_SPECS.items()}


def build_vit(arch: str, num_classes: Optional[int] = None,
              remat: Union[bool, str] = False,
              img_size: Union[int, Sequence[int]] = 224) -> ViT:
    return ViT(num_classes=num_classes, remat=remat, img_size=img_size,
               **VIT_SPECS[arch])
