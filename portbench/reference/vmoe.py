"""V-MoE encoders in plain PyTorch (float32; the benchmark's reference).

Riquelme et al., "Scaling Vision with Sparse Mixture of Experts", NeurIPS
2021 (arXiv:2106.05974), "Every-2": the ViT of `nets` with the MLP of
every other block replaced by E experts (each Linear-GELU-Linear, D -> 4D
-> D, tanh GELU) of which each token takes its k largest gates. Written
from the paper's equations, not from the program's slot map:

  logits = W_r x (no bias);  p = softmax(logits + eps),
  eps ~ N(0, 1/E^2) in training;  y = sum over x's top-k of p_i e_i(x).

Each expert takes the first C = round(k N ratio / E) of the choices made
of it in priority order: every token's first choice, in token order, then
every second choice. Here that is a loop over the experts, each gathering
its choices in that order, cutting at C, running its MLP on the rows and
adding them, weighted by their gates, into the output (`index_add_`).

The auxiliary loss of a group is (L_imp + L_load) / 2, L_imp the squared
coefficient of variation (population variance over the squared mean) of
sum_x p(x), L_load that of sum_x P(x) with P_i(x) = 1 - Phi((eta_k(x) -
(W_r x)_i) / sigma) = erfc(. / sqrt 2) / 2, sigma = 1/E, eta_k(x) the k-th
largest noisy logit (the paper's appendix A).

Departures from the paper, each the program's too (the configuration's
`assumed`):
- a routing group is one encoder call (one view of one modality, B x 197
  tokens), not a fixed group size;
- vanilla priority only (no batch-prioritised routing);
- the step's loss adds 0.01 x the mean of the aux loss over the blocks and
  the step's groups;
- the noise of an encoder call is given, drawn by the program's rule
  (`noises`).

The router's product stays float32 under `Numerics` (the configuration
states it float32); the experts' products and the attention's go through
`Numerics`, so the fp8 control rounds them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import nets, prng


class Router(nn.Module):
    def __init__(self, dim, experts):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, dim))


class Stacked(nn.Module):
    """E linear maps, expert e's rows e * out .. (e + 1) * out of one
    (E x out, fan_in) weight and its bias."""

    def __init__(self, experts, fan_in, out):
        super().__init__()
        self.out = out
        self.weight = nn.Parameter(torch.empty(experts * out, fan_in))
        self.bias = nn.Parameter(torch.empty(experts * out))
        self.num = nets.Numerics()

    def expert(self, e, x):
        rows = slice(e * self.out, (e + 1) * self.out)
        return (self.num.product(F.linear, x, self.weight[rows])
                + self.bias[rows])


def cv2(v: torch.Tensor) -> torch.Tensor:
    return v.var(unbiased=False) / v.mean() ** 2


class Experts(nn.Module):
    def __init__(self, dim, hidden, experts, k, ratio):
        super().__init__()
        self.experts, self.k, self.ratio = experts, k, ratio
        self.router = Router(dim, experts)
        self.fc1 = Stacked(experts, dim, hidden)
        self.fc2 = Stacked(experts, hidden, dim)

    def forward(self, h, noise):
        """(y, aux or None, dropped choices) of one group, `noise` (N, E)
        or None (eval)."""
        b, s, d = h.shape
        x = h.reshape(b * s, d)
        n, e_count, k = x.shape[0], self.experts, self.k
        logits = F.linear(x, self.router.weight)
        noisy = logits if noise is None else logits + noise
        p = torch.softmax(noisy, dim=-1)
        top_p, top_i = torch.topk(p, k, dim=-1)
        cap = max(1, int(round(k * n * self.ratio / e_count)))
        y = torch.zeros_like(x)
        dropped = 0
        for e in range(e_count):
            toks, gates = [], []
            for j in range(k):
                t = torch.nonzero(top_i[:, j] == e).flatten()
                toks.append(t)
                gates.append(top_p[t, j])
            tok, gate = torch.cat(toks), torch.cat(gates)
            dropped += max(0, tok.numel() - cap)
            tok, gate = tok[:cap], gate[:cap]
            if tok.numel() == 0:
                continue
            mid = F.gelu(self.fc1.expert(e, x[tok]), approximate="tanh")
            y = y.index_add(0, tok, self.fc2.expert(e, mid) * gate[:, None])
        aux = None
        if noise is not None:
            eta = noisy.sort(dim=-1, descending=True).values[:, k - 1:k]
            z = (eta - logits) * e_count
            load = 0.5 * torch.erfc(z / math.sqrt(2.0))
            aux = 0.5 * (cv2(p.sum(0)) + cv2(load.sum(0)))
        return y.view(b, s, d), aux, dropped


class MoEBlock(nn.Module):
    def __init__(self, dim, heads, hidden, eps, experts, k, ratio):
        super().__init__()
        self.ln1, self.attn = nets.LayerNorm(dim, eps), nets.Attention(dim,
                                                                       heads)
        self.ln2 = nets.LayerNorm(dim, eps)
        self.moe = Experts(dim, hidden, experts, k, ratio)

    def forward(self, x, noise):
        x = x + self.attn(self.ln1(x))
        y, aux, dropped = self.moe(self.ln2(x), noise)
        return x + y, aux, dropped


class VMoE(nn.Module):
    """`nets.ViT` with `MoEBlock`s at `moe_blocks`; forward(x, noises) ->
    (feature, aux of the blocks' mean or None, dropped choices), `noises`
    one (N, E) a MoE block in order, or None (eval)."""

    def __init__(self, patch, dim, depth, heads, mlp_ratio, img, eps,
                 experts, k, moe_blocks, ratio):
        super().__init__()
        self.depth, self.moe_blocks = depth, tuple(moe_blocks)
        self.experts = experts
        hidden = int(dim * mlp_ratio)
        self.patch_embed = nets.Conv(3, dim, patch, patch, 0, bias=True)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (img // patch) ** 2 + 1,
                                                  dim))
        for i in range(depth):
            blk = (MoEBlock(dim, heads, hidden, eps, experts, k, ratio)
                   if i in self.moe_blocks
                   else nets.Block(dim, heads, hidden, eps))
            self.add_module(f"block{i}", blk)
        self.ln_final = nets.LayerNorm(dim, eps)
        self.feat_dim = dim

    def forward(self, x, noises=None):
        x = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls.expand(x.shape[0], 1, -1), x], dim=1)
        x = x + self.pos_embed
        aux, dropped, m = [], 0, 0
        for i in range(self.depth):
            blk = getattr(self, f"block{i}")
            if i not in self.moe_blocks:
                x = blk(x)
                continue
            x, a, d = blk(x, None if noises is None else noises[m])
            m += 1
            aux.append(a)
            dropped += d
        mean = None if noises is None else torch.stack(aux).mean()
        return self.ln_final(x)[:, 0], mean, dropped


def noises(generator: torch.Generator, calls: int, tokens: int, experts: int,
           blocks: int, device) -> list:
    """The program's rule for one encoder's router noise in a step: from
    its generator, for each call (view 1, then view 2) and each MoE block
    in order, a float32 (N, E) normal times 1 / E."""
    return [[torch.randn((tokens, experts), generator=generator,
                         device=device) * (1.0 / experts)
             for _ in range(blocks)] for _ in range(calls)]


def router_generators(step_seed: int, device) -> list:
    """The derm encoder's router generator (the step's seed with 3 folded
    in) and the clinic encoder's (4)."""
    return [prng.generator(prng.fold_in(step_seed, 3 + m), device)
            for m in range(2)]
