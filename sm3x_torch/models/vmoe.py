"""V-MoE encoders: a ViT whose every other block's MLP is a sparse mixture
of experts (Riquelme et al., "Scaling Vision with Sparse Mixture of
Experts", NeurIPS 2021, arXiv:2106.05974; the "Every-2" layout). The port's
own model: the JAX package has no counterpart.

V-MoE-B/16 is ViT-B/16 (sm3x_torch.models.vit) with the MLP of blocks 1,
3, ..., 11 (0-based) replaced by `ExpertLayer`: E = 32 experts, each an MLP
D -> 4D -> D with tanh GELU, and k = 2 experts a token. Per routing group
of N tokens (here the tokens of one encoder call: one view of one
modality, B x 197 tokens):

  logits  = W_r x                       router, float32 even under autocast
  p(x)    = softmax(logits + eps)       eps ~ N(0, 1/E^2) in training only
  y       = sum over x's top-k of p_i(x) e_i(x)   (not renormalised)

with each expert taking at most C = round(k N 1.05 / E) choices of the
group, first choices before second ones, each in token order
(sm3x_torch.ops.moe); a dropped choice adds nothing and the residual
carries the token. In training each block adds the group's auxiliary loss
(L_imp + L_load) / 2 (`sm3x_torch.ops.moe.aux_loss`); the step's loss adds
`AUX_WEIGHT` (0.01) times the mean over the blocks and the groups of a
step (`routing`). The experts run in the autocast dtype (bf16) as two
batched products over (E, C, D); dispatch and combine are kernel K5 on the
card.

Randomness: the router's noise of an encoder call comes from the
encoder's `generator` (`routing` sets it for a step): one float32 (N, E)
normal times 1 / E a MoE block, in block order, drawn before the blocks
run, so a block that --use-checkpoint recomputes sees the same noise.

Parameter names: a dense block's as in `ViT`; a MoE block's
`block{i}.{ln1,attn.*,ln2}` and `block{i}.moe.router.weight` (E, D),
`block{i}.moe.fc1.{weight,bias}` (E x 4D, D) / (E x 4D,) and
`block{i}.moe.fc2.{weight,bias}` (E x D, 4D) / (E x D,): each expert's
rows stacked along the first dim, so that an initialiser that reads the
fan-in from the trailing dims gives each expert a dense MLP's scale.

Not taken: tensor parallelism (`split_for_model` refuses: expert
parallelism is not ported) and the Flax weight mapping
(sm3x_torch.utils.weights.vit_state_dict refuses a V-MoE tree). Under the
"mlp" and "attn_mlp" modes a MoE block's expert layer is not recomputed.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from sm3x_torch.models.vit import (LN_EPS, MultiHeadAttention, ViT,
                                   lecun_normal_, torch_linear_init_)
from sm3x_torch.ops import moe as moe_ops
from sm3x_torch.utils.profiling import annotate

VMOE_SPECS = {
    "vmoe_b16": dict(patch=16, dim=768, depth=12, n_heads=12, experts=32,
                     k=2, moe_blocks=(1, 3, 5, 7, 9, 11),
                     capacity_ratio=1.05),
}
AUX_WEIGHT = 0.01


class StackedLinear(nn.Module):
    """E linear maps of `fan_in` -> `out`, stored as one (E x out, fan_in)
    weight and an (E x out,) bias; applied to (E, C, fan_in) by one batched
    product."""

    def __init__(self, experts: int, fan_in: int, out: int):
        super().__init__()
        self.experts, self.fan_in, self.out = experts, fan_in, out
        self.weight = nn.Parameter(torch.empty(experts * out, fan_in))
        self.bias = nn.Parameter(torch.zeros(experts * out))
        torch_linear_init_(self.weight, fan_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = self.experts
        return torch.baddbmm(self.bias.view(e, 1, self.out), x,
                             self.weight.view(e, self.out,
                                              self.fan_in).transpose(1, 2))


class ExpertLayer(nn.Module):
    """The router, the slot map, the experts and the combine of one MoE
    block; forward(h (B, S, D), noise (B S, E) or None) -> (y (B, S, D),
    aux or None, dropped choices)."""

    def __init__(self, dim: int, hidden: int, experts: int, k: int,
                 capacity_ratio: float):
        super().__init__()
        self.experts, self.k, self.capacity_ratio = experts, k, capacity_ratio
        self.router = nn.Linear(dim, experts, bias=False)
        lecun_normal_(self.router.weight, dim)
        self.fc1 = StackedLinear(experts, dim, hidden)
        self.fc2 = StackedLinear(experts, hidden, dim)

    def capacity(self, tokens: int) -> int:
        return moe_ops.capacity(tokens, self.k, self.experts,
                                self.capacity_ratio)

    def forward(self, h: torch.Tensor, noise: Optional[torch.Tensor]):
        b, s, d = h.shape
        flat = h.reshape(b * s, d)
        dev = flat.device.type
        with annotate("moe.route"), torch.autocast(dev, enabled=False):
            logits = F.linear(flat.float(), self.router.weight.float())
            noisy = logits if noise is None else logits + noise
            p = torch.softmax(noisy, dim=-1)
            gates, choices = p.topk(self.k, dim=-1)
            smap = moe_ops.slot_map(choices, self.experts,
                                    self.capacity(b * s))
            aux = (None if noise is None else moe_ops.aux_loss(
                p, logits, noisy, self.k, 1.0 / self.experts))
        with annotate("moe.experts"):
            if torch.is_autocast_enabled(dev):
                flat = flat.to(torch.get_autocast_dtype(dev))
            slots = moe_ops.dispatch(flat, smap)
            e, c = self.experts, slots.shape[0] // self.experts
            mid = F.gelu(self.fc1(slots.view(e, c, d)), approximate="tanh")
            y = self.fc2(mid).reshape(e * c, d)
            out = moe_ops.combine(y, gates, smap)
        return out.view(b, s, d), aux, smap.dropped


class MoEBlock(nn.Module):
    """A pre-LN ViT block whose MLP is an `ExpertLayer`; forward(x, noise)
    -> (x, aux or None, dropped)."""

    tp_kind = "vit"   # sm3x_torch.parallel.tensor.tensor_parallel

    def __init__(self, dim: int, n_heads: int, mlp_ratio: float,
                 attn_impl: str, experts: int, k: int,
                 capacity_ratio: float):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, n_heads, attn_impl)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.moe = ExpertLayer(dim, int(dim * mlp_ratio), experts, k,
                               capacity_ratio)

    def split_for_model(self, size: int, index: int, group) -> None:
        raise ValueError(
            "--mesh-model > 1: a V-MoE block's expert layer cannot be split "
            "over a model axis (expert parallelism is not ported); run "
            "V-MoE with --mesh-model 1")

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor]):
        x = x + self.attn(self.ln1(x))
        y, aux, dropped = self.moe(self.ln2(x), noise)
        return x + y, aux, dropped


class VMoE(ViT):
    """ViT with `MoEBlock`s at `moe_blocks` (see the module's docstring).
    `generator` draws the router's noise in training (None: the default
    generator); `moe_log`, where `routing` set it to a list, receives one
    (aux, dropped, choices) a training call: aux the mean over the blocks,
    dropped their dropped choices, choices their k N choices."""

    def __init__(self, patch: int = 16, dim: int = 768, depth: int = 12,
                 n_heads: int = 12, mlp_ratio: float = 4.0,
                 num_classes: Optional[int] = None,
                 remat: Union[bool, str] = False,
                 img_size: Union[int, Sequence[int]] = 224,
                 experts: int = 32, k: int = 2,
                 moe_blocks: Sequence[int] = (1, 3, 5, 7, 9, 11),
                 capacity_ratio: float = 1.05):
        super().__init__(patch, dim, depth, n_heads, mlp_ratio, num_classes,
                         remat, img_size)
        self.moe_blocks = tuple(sorted(moe_blocks))
        self.experts, self.k = experts, k
        for i in self.moe_blocks:
            setattr(self, f"block{i}", MoEBlock(
                dim, n_heads, mlp_ratio, self.attn_impl, experts, k,
                capacity_ratio))
        self.generator = None
        self.moe_log = None

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        noises = {}
        if self.training:
            n = x.shape[0] * x.shape[1]
            noises = {i: moe_ops.noise(n, self.experts, self.generator,
                                       x.device) for i in self.moe_blocks}
        aux, dropped = [], []
        for i, blk in enumerate(self.blocks()):
            if i not in self.moe_blocks:
                x = self._run_block(blk, x)
                continue
            x, a, d = self._run_block(blk, x, noises.get(i))
            aux.append(a)
            dropped.append(d)
        if self.training and self.moe_log is not None:
            choices = self.k * x.shape[0] * x.shape[1] * len(self.moe_blocks)
            self.moe_log.append((torch.stack(aux).mean(),
                                 torch.stack(dropped).sum(), choices))
        return x


def moe_encoders(model: nn.Module) -> list:
    """The `VMoE` encoders of `model` in module order (a dual encoder: the
    derm encoder, then the clinic one)."""
    return [m for m in model.modules() if isinstance(m, VMoE)]


class RoutingLog:
    """What a step's routing leaves: one (aux, dropped, choices) an encoder
    call in training."""

    def __init__(self):
        self.calls = []

    def add_to(self, total: torch.Tensor, parts: dict) -> tuple:
        """(total + AUX_WEIGHT x the mean aux over the calls, parts with
        `moe_aux`, `moe_dropped` and `moe_assignments`, the calls' choices);
        as they were where no call routed."""
        if not self.calls:
            return total, parts
        aux = torch.stack([a for a, _, _ in self.calls]).mean()
        dropped = torch.stack([d for _, d, _ in self.calls]).sum()
        choices = total.new_full((), float(sum(c for _, _, c in self.calls)))
        parts = {**parts, "moe_aux": aux, "moe_dropped": dropped,
                 "moe_assignments": choices}
        return total + AUX_WEIGHT * aux, parts


@contextlib.contextmanager
def routing(model: nn.Module, generators=None):
    """Inside the block each `VMoE` of `model` draws its router noise from
    its generator in `generators` (in `moe_encoders` order; None: the
    default generator) and logs its training calls into the `RoutingLog`
    this yields; both are cleared on the way out."""
    encoders = moe_encoders(model)
    log = RoutingLog()
    for i, enc in enumerate(encoders):
        enc.generator = generators[i] if generators else None
        enc.moe_log = log.calls
    try:
        yield log
    finally:
        for enc in encoders:
            enc.generator, enc.moe_log = None, None


def build_vmoe(arch: str, num_classes: Optional[int] = None,
               remat: Union[bool, str] = False,
               img_size: Union[int, Sequence[int]] = 224) -> VMoE:
    return VMoE(num_classes=num_classes, remat=remat, img_size=img_size,
                **VMOE_SPECS[arch])
