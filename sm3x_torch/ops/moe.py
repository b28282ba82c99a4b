"""The sparse-expert layer's routing and token moves (V-MoE, Riquelme et al.
2021, arXiv:2106.05974): the router's choices, the capacity cut with
vanilla priority, the auxiliary loss, and dispatch / combine as autograd
Functions whose four directions are kernel K5 on the card
(sm3x_torch/ops/moe_cuda.py) and the plain versions below on the CPU.

One routing group is N tokens; each takes its k largest gates of E experts,
and each expert at most C = round(k N ratio / E) of the group's choices.
Vanilla priority: every token's first choice is placed before any second
choice, each in token order; a choice past its expert's C is dropped (the
residual carries the token). The slot map that `slot_map` builds makes
every direction of the token moves a gather:

  token_slot   (N, k) int32   the slot e * C + position of each choice,
                              -1 where it was dropped
  slot_assign  (S,) int32     the choice t * k + j a slot holds, -1 where
                              the slot is empty (S = E * C)

Every shape is static and nothing reads a value back, so a step that
routes still records as one CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sm3x_torch.ops import moe_cuda


def capacity(tokens: int, k: int, experts: int, ratio: float) -> int:
    """Slots an expert of a group of `tokens`: round(k N ratio / E), at
    least 1 (V-MoE's `round`, Python's)."""
    return max(1, int(round(k * tokens * ratio / experts)))


class SlotMap(NamedTuple):
    token_slot: torch.Tensor    # (N, k) int32
    slot_assign: torch.Tensor   # (E * C,) int32
    dropped: torch.Tensor       # () float32: choices past their capacity


def slot_map(choices: torch.Tensor, experts: int, cap: int) -> SlotMap:
    """The slot map of `choices` ((N, k) expert indices, column j a token's
    j-th choice) under a capacity of `cap` slots an expert, vanilla
    priority."""
    n, k = choices.shape
    order = choices.t().reshape(-1)                    # first choices first
    # one row of k N a expert, scanned as one flat array (one parallel scan
    # over E k N values; a scan down 25k rows of 32 took ~4.6 ms on an
    # H100), each row's running count less the rows' before it
    hits = torch.zeros((experts, n * k), dtype=torch.int32,
                       device=choices.device)
    hits.scatter_(0, order[None, :], 1)
    seen = hits.view(-1).cumsum(0, dtype=torch.int32).view(experts, n * k)
    before = torch.cat([seen.new_zeros(1), seen[:-1, -1]])
    position = ((seen - before[:, None]) * hits).sum(0) - 1
    kept = position < cap
    slot = torch.where(kept, order * cap + position, -1)
    token_slot = slot.view(k, n).t().contiguous().int()
    choice = (torch.arange(n, device=choices.device)[None, :] * k
              + torch.arange(k, device=choices.device)[:, None]).reshape(-1)
    # dropped choices all land on one extra slot, cut off after
    slot_assign = torch.full((experts * cap + 1,), -1, dtype=torch.int32,
                             device=choices.device)
    slot_assign.scatter_(0, torch.where(kept, slot, experts * cap),
                         choice.int())
    dropped = (~kept).sum().float()
    return SlotMap(token_slot, slot_assign[:-1].contiguous(), dropped)


def _cv2(x: torch.Tensor) -> torch.Tensor:
    """The squared coefficient of variation (population std over mean)."""
    return (x.std(correction=0) / x.mean()) ** 2


def aux_loss(gates: torch.Tensor, logits: torch.Tensor, noisy: torch.Tensor,
             k: int, noise_std: float) -> torch.Tensor:
    """V-MoE's auxiliary loss of one group (the paper's appendix A):
    (L_imp + L_load) / 2 with L_imp = CV(sum_x p(x))^2 over the noisy gates
    and L_load = CV(sum_x P(x))^2, P_i(x) = 1 - Phi((eta_k(x) - (W x)_i) /
    sigma), eta_k the k-th largest noisy logit."""
    importance = _cv2(gates.sum(0))
    eta = noisy.topk(k, dim=-1).values[:, -1:]
    load = _cv2((1.0 - torch.special.ndtr((eta - logits) / noise_std)).sum(0))
    return 0.5 * (importance + load)


# --- plain versions (the CPU path and K5's twin) ---------------------------

def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def _padded(rows: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """rows[index] in the compute dtype, zeros where index < 0."""
    z = torch.cat([rows.to(_compute_dtype(rows)),
                   rows.new_zeros((1, rows.shape[1]),
                                  dtype=_compute_dtype(rows))])
    return z[torch.where(index < 0, rows.shape[0], index).long()]


def dispatch_plain(x: torch.Tensor, slot_assign: torch.Tensor,
                   k: int) -> torch.Tensor:
    """(S, D): slot s the row of token slot_assign[s] // k, zeros where
    empty."""
    tok = torch.where(slot_assign < 0, -1, slot_assign // k)
    return _padded(x, tok).to(x.dtype)


def combine_plain(y: torch.Tensor, gates: torch.Tensor,
                  token_slot: torch.Tensor) -> torch.Tensor:
    """(N, D): each token's choices' slot rows weighted by their gates,
    summed in float32 and rounded once."""
    rows = _padded(y, token_slot) * gates.to(_compute_dtype(y))[..., None]
    return rows.sum(1).to(y.dtype)


def combine_backward_plain(dout: torch.Tensor, y: torch.Tensor,
                           gates: torch.Tensor, slot_assign: torch.Tensor,
                           token_slot: torch.Tensor) -> tuple:
    """(dy (S, D), dgates (N, k)): dy[s] = g[a] dout[a // k] (zeros where
    empty), dgates[t, j] = dout[t] . y[slot(t, j)] (0 where dropped)."""
    k = token_slot.shape[1]
    flat = torch.cat([gates.reshape(-1), gates.new_zeros(1)])
    a = torch.where(slot_assign < 0, gates.numel(), slot_assign).long()
    tok = torch.where(slot_assign < 0, -1, slot_assign // k)
    dt = _compute_dtype(y)
    dy = (_padded(dout, tok) * flat[a].to(dt)[:, None]).to(y.dtype)
    dgates = (dout.to(dt)[:, None, :] * _padded(y, token_slot)).sum(-1)
    return dy, dgates.to(gates.dtype)


def dispatch_backward_plain(dslots: torch.Tensor,
                            token_slot: torch.Tensor) -> torch.Tensor:
    """(N, D): the sum of each token's choices' slot gradients."""
    return _padded(dslots, token_slot).sum(1).to(dslots.dtype)


class Dispatch(torch.autograd.Function):
    """Token rows into their slots (K5 dispatch on the card)."""

    @staticmethod
    def forward(ctx, x, token_slot, slot_assign):
        k = token_slot.shape[1]
        ctx.save_for_backward(token_slot)
        if x.is_cuda:
            return moe_cuda.moe_dispatch_cuda(x.contiguous(), slot_assign, k)
        return dispatch_plain(x, slot_assign, k)

    @staticmethod
    def backward(ctx, dslots):
        (token_slot,) = ctx.saved_tensors
        dslots = dslots.contiguous()
        if dslots.is_cuda:
            dx = moe_cuda.moe_dispatch_backward_cuda(dslots, token_slot)
        else:
            dx = dispatch_backward_plain(dslots, token_slot)
        return dx, None, None


class Combine(torch.autograd.Function):
    """Slot rows back into tokens, weighted by the gates (K5 combine on the
    card)."""

    @staticmethod
    def forward(ctx, y, gates, token_slot, slot_assign):
        y, gates = y.contiguous(), gates.contiguous()
        ctx.save_for_backward(y, gates, token_slot, slot_assign)
        if y.is_cuda:
            return moe_cuda.moe_combine_cuda(y, gates, token_slot)
        return combine_plain(y, gates, token_slot)

    @staticmethod
    def backward(ctx, dout):
        y, gates, token_slot, slot_assign = ctx.saved_tensors
        dout = dout.to(y.dtype).contiguous()
        if y.is_cuda:
            dy, dgates = moe_cuda.moe_combine_backward_cuda(
                dout, y, gates, slot_assign, token_slot.shape[1])
        else:
            dy, dgates = combine_backward_plain(dout, y, gates, slot_assign,
                                                token_slot)
        return dy, dgates, None, None


def dispatch(x: torch.Tensor, smap: SlotMap) -> torch.Tensor:
    return Dispatch.apply(x, smap.token_slot, smap.slot_assign)


def combine(y: torch.Tensor, gates: torch.Tensor,
            smap: SlotMap) -> torch.Tensor:
    return Combine.apply(y, gates, smap.token_slot, smap.slot_assign)


def noise(tokens: int, experts: int, generator, device) -> torch.Tensor:
    """The router's noise of one group: a float32 (N, E) normal from
    `generator` times 1 / E (the paper's sigma)."""
    return torch.randn((tokens, experts), generator=generator,
                       device=device) * (1.0 / experts)
