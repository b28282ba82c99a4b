"""The port's attention (sm3x_torch.ops.attention) against the JAX package's
(sm3x/models/vit.py) on the CPU, in float32 with numpy inputs made from a
seed.

* `attention_plain` against Flax's `nn.dot_product_attention`, and against
  the TPU flash kernel's own reference `mha_reference` fed the padded,
  segment-masked inputs of `_pad_for_flash`: rtol / atol 1e-5
  (tests/test_vit_trimodal.py:77). Its lse against a logsumexp in numpy.
* `attention_backward_plain`, the analytic gradient the kernels compute,
  against `jax.grad` through `_flash_attention_fn` (off the TPU it is the
  checkpointed XLA attention) and against torch autograd of the plain
  forward: rtol 2e-4 / atol 2e-5 (tests/test_vit_trimodal.py:46).
* `attention_backward_plain(..., operand_dtype=torch.bfloat16)`, the
  arithmetic of the tensor-core K3b, against the TPU flash kernel itself
  (JAX's Pallas library kernel, run in Pallas interpret mode on bf16
  inputs, fed as `_flash_attention_fn` feeds it). Without the option the
  function is bit for bit the float32 formula it always was.
* `FlashAttention` and the mode table on CPU tensors: the plain versions,
  no kernel launched.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3x.models.vit import _flash_attention_fn, _pad_for_flash
from sm3x_torch.ops import attention as A
from sm3x_torch.ops import attention_cuda as K

torch.set_num_threads(2)

SHAPES = [(2, 197, 3, 8), (2, 70, 2, 64)]


def _inputs(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_flax_and_the_kernel_reference(shape):
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    q, k, v, _ = _inputs(shape, seed=shape[1])
    scale = 1.0 / math.sqrt(shape[3])
    out, lse = A.attention_plain(*map(torch.from_numpy, (q, k, v)), scale)
    assert out.dtype == lse.dtype == torch.float32
    assert lse.shape == (shape[0], shape[2], shape[1])

    ref = fnn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    qp, kp, vp, seg, _ = _pad_for_flash(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    ref_fa = fa.mha_reference(qp, kp, vp, None,
                              segment_ids=fa.SegmentIds(seg, seg),
                              sm_scale=scale)
    ref_fa = np.transpose(np.asarray(ref_fa)[:, :, :shape[1]], (0, 2, 1, 3))
    np.testing.assert_allclose(out.numpy(), ref_fa, rtol=1e-5, atol=1e-5)

    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * scale
    mx = s.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_grad_and_torch_autograd(shape):
    q, k, v, do = _inputs(shape, seed=7 + shape[1])
    scale = 1.0 / math.sqrt(shape[3])
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    out, lse = A.attention_plain(*t[:3], scale)
    grads = A.attention_backward_plain(*t[:3], out, t[3], lse, scale)

    _, vjp = jax.vjp(_flash_attention_fn, jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v))
    for got, want in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-5)

    leaves = [x.clone().requires_grad_(True) for x in t[:3]]
    A.attention_plain(*leaves, scale)[0].backward(t[3])
    for got, leaf in zip(grads, leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=2e-4, atol=2e-5)


def _rel(got, want):
    """Relative Frobenius error."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("shape", [(2, 197, 2, 64), (2, 50, 2, 64)])
def test_bf16_plain_backward_matches_the_tpu_kernel(shape):
    """The TPU kernel's dq / dk / dv are bf16. Against them, the plain
    backward in bf16 arithmetic, rounded to bf16, measured at most 1.0e-4
    relative Frobenius error (bound 5e-4), and 1.7e-3 unrounded (bound
    1e-2). The float32 plain backward, rounded, measured 2.3e-3 to 2.4e-3:
    the bound tells the two arithmetics apart."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    s, d = shape[1], shape[3]
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16)
                   for a in _inputs(shape, seed=3 + s))

    def kernel(q, k, v):  # sm3x/models/vit.py:83-87, on any backend
        qp, kp, vp, seg, _ = _pad_for_flash(q, k, v)
        out = fa.flash_attention(qp, kp, vp,
                                 segment_ids=fa.SegmentIds(seg, seg),
                                 sm_scale=scale)
        return jnp.transpose(out[:, :, :s, :], (0, 2, 1, 3)).astype(q.dtype)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(kernel, q, k, v)
        want = vjp(do)
    assert out.dtype == jnp.bfloat16
    assert all(w.dtype == jnp.bfloat16 for w in want)
    t = [torch.from_numpy(np.asarray(x, np.float32))
         for x in (q, k, v, do, out)]
    _, lse = A.attention_plain(*t[:3], scale)
    got = A.attention_backward_plain(*t[:3], t[4], t[3], lse, scale,
                                     operand_dtype=torch.bfloat16)
    f32 = A.attention_backward_plain(*t[:3], t[4], t[3], lse, scale)
    for g, f, w in zip(got, f32, want):
        w = torch.from_numpy(np.asarray(w, np.float32))
        assert _rel(g.bfloat16(), w) < 5e-4
        assert _rel(g, w) < 1e-2
        assert _rel(f.bfloat16(), w) > 1e-3


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_without_operand_dtype_is_the_float32_formula(shape):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape, seed=11))
    scale = 1.0 / math.sqrt(shape[3])
    out, lse = A.attention_plain(q, k, v, scale)
    got = A.attention_backward_plain(q, k, v, out, do, lse, scale)
    # the function as it stood before `operand_dtype`
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
                  - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * out).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    for g, w in zip(got, (dq, dk, dv)):
        assert torch.equal(g, w)


def test_flash_function_on_cpu_takes_the_plain_versions():
    shape = (2, 65, 2, 64)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape, seed=3))
    counters = (K.flash_forward_cuda, K.flash_backward_dq_cuda,
                K.flash_backward_dkv_cuda)
    before = [fn.launches for fn in counters]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = A.flash_attention(*leaves)
    out.backward(do)
    assert [fn.launches for fn in counters] == before

    want, lse = A.attention_plain(q, k, v, 1 / 8.0)
    torch.testing.assert_close(out.detach(), want, rtol=1e-6, atol=1e-6)
    for got, want_g in zip(leaves, A.attention_backward_plain(
            q, k, v, want, do, lse, 1 / 8.0)):
        torch.testing.assert_close(got.grad, want_g, rtol=1e-6, atol=1e-6)

    # bf16 in, bf16 out and bf16 gradients in the bf16 arithmetic of the
    # tensor-core K3b, as on the card
    lb = [x.bfloat16().requires_grad_(True) for x in (q, k, v)]
    ob = A.flash_attention(*lb)
    ob.backward(do.bfloat16())
    assert ob.dtype == torch.bfloat16
    assert all(x.grad.dtype == torch.bfloat16 for x in lb)
    fb = [x.detach().float() for x in lb]
    _, lse_b = A.attention_plain(*fb, 1 / 8.0)
    for got, want_g in zip(lb, A.attention_backward_plain(
            *fb, ob.detach().float(), do.bfloat16().float(), lse_b, 1 / 8.0,
            operand_dtype=torch.bfloat16)):
        assert torch.equal(got.grad, want_g.bfloat16())


def test_attention_modes_agree_on_cpu():
    assert set(A.ATTENTION_FNS) == {"xla", "attn", "flash"}
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((2, 33, 3, 64), 5))
    results = {}
    for mode, fn in A.ATTENTION_FNS.items():
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        results[mode] = [out.detach()] + [x.grad for x in leaves]
    for mode in ("attn", "flash"):
        for got, want in zip(results[mode], results["xla"]):
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 4, 1, 64)
    lse = torch.zeros(1, 1, 4)
    calls = [lambda: K.flash_forward_cuda(q, q, q, 0.125),
             lambda: K.flash_backward_dq_cuda(q, q, q, q, q, lse, 0.125),
             lambda: K.flash_backward_dkv_cuda(q, q, q, q, lse, lse, 0.125)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
