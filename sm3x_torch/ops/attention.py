"""Attention of the ViT blocks (counterpart of sm3x/models/vit.py:23-94):
the plain versions, the analytic backward that the flash kernels compute,
the autograd Function that joins them, and the mode table.

Every function takes q, k, v in the Flax layout (B, S, H, D) and returns
(B, S, H, D), as Flax's `attention_fn` does.

Modes (`ATTENTION_FNS`):
  xla    softmax(q k^T / sqrt(D)) v by autograd, which saves the
         (B, H, S, S) probabilities for the backward;
  attn   the same under `torch.utils.checkpoint`: the backward recomputes
         the probabilities from q and k;
  flash  `FlashAttention`: saves q, k, v, the output and the per-row
         logsumexp, and recomputes the probabilities tile by tile. On a
         CUDA tensor it launches kernels K3f, K3b-dq and K3b-dkv
         (sm3x_torch/ops/attention_cuda.py) or raises; on a CPU tensor it
         takes the plain versions below. The bf16 backward rounds P and dS
         to bf16 before their products, as the TPU kernel and the
         tensor-core K3b do.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from sm3x_torch.ops import attention_cuda


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def attention_plain(q, k, v, scale: float):
    """softmax(q k^T * scale) v in float32 (float64 for float64 inputs):
    (out (B, S, H, D), lse (B, H, S)), the values K3f computes."""
    dt = _compute_dtype(q)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", p, v), lse


def attention_backward_plain(q, k, v, out, dout, lse, scale: float,
                             operand_dtype: torch.dtype | None = None):
    """The analytic gradient that K3b-dq and K3b-dkv compute, in torch (not
    autograd): P = exp(S * scale - lse), Delta = rowsum(dO o O),
    dS = P o (dP - Delta) with dP = dO V^T; dQ = scale dS K,
    dK = scale dS^T Q, dV = P^T dO. Returns (dq, dk, dv).

    `operand_dtype=torch.bfloat16` is the arithmetic of the TPU kernel
    (flash_attention.py:900, 918, 1258) and of the tensor-core K3b: P and
    scale dS are rounded to bf16 before the products that consume them
    (dV = P^T dO, dK = (scale dS)^T Q, dQ = (scale dS) K). S, the
    exponent, Delta, dP and every sum stay float32. With None the result
    is the float32 one."""
    dt = _compute_dtype(q)
    q, k, v, out, dout = (t.to(dt) for t in (q, k, v, out, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - lse.to(dt)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, v)
    delta = (dout * out).sum(-1).transpose(1, 2)  # (B, H, S)
    ds = p * (dp - delta[..., None])
    if operand_dtype is None:
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    else:
        p = p.to(operand_dtype).to(dt)
        ds = (ds * scale).to(operand_dtype).to(dt)
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T * scale) v that saves only q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.is_cuda:
            out, lse = attention_cuda.flash_forward_cuda(q, k, v, scale)
        else:
            out, lse = attention_plain(q, k, v, scale)
            out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        if q.is_cuda:
            dq, delta = attention_cuda.flash_backward_dq_cuda(
                q, k, v, out, dout, lse, ctx.scale)
            dk, dv = attention_cuda.flash_backward_dkv_cuda(
                q, k, v, dout, lse, delta, ctx.scale)
        else:  # bf16 in the kernels' bf16 arithmetic, as on the card
            operand = torch.bfloat16 if q.dtype == torch.bfloat16 else None
            dq, dk, dv = (g.to(q.dtype) for g in attention_backward_plain(
                q, k, v, out, dout, lse, ctx.scale, operand_dtype=operand))
        return dq, dk, dv, None


def attention_xla(q, k, v):
    """Flax's `nn.dot_product_attention` without mask or dropout; the
    softmax runs in float32 (float64 for float64 inputs)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(q.shape[-1]), k)
    p = torch.softmax(s.to(_compute_dtype(s)), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention_remat(q, k, v):
    """`attention_xla` under checkpoint (the JAX package's
    `_remat_attention_fn`)."""
    if not torch.is_grad_enabled():
        return attention_xla(q, k, v)
    return checkpoint(attention_xla, q, k, v, use_reentrant=False)


def flash_attention(q, k, v):
    """`FlashAttention` at the scale 1 / sqrt(D)."""
    return FlashAttention.apply(q, k, v, 1.0 / math.sqrt(q.shape[-1]))


ATTENTION_FNS = {
    "xla": attention_xla,
    "attn": attention_remat,
    "flash": flash_attention,
}
