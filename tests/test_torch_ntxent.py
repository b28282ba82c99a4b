"""NT-Xent in the PyTorch port (sm3x_torch.ops.ntxent, ntxent_cuda and
losses.ssl) against the JAX package on the same numpy inputs, on the CPU.

The Pallas kernel runs in interpret mode, as tests/test_ntxent_pallas.py
runs it. Tolerances are that file's: loss rtol 1e-5, gradients rtol 1e-4
with atol 1e-6 (float32 sums in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.losses.ssl import ssl_loss as jax_ssl_loss
from sm3x.ops import ntxent as jnt
from sm3x.ops.ntxent_pallas import ntxent_loss_pallas
from sm3x_torch.losses.ssl import ssl_loss
from sm3x_torch.ops import ntxent as tnt
from sm3x_torch.ops import ntxent_cuda as K

torch.set_num_threads(2)


def _z(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_forward_matches_xla_and_pallas(rng_np):
    b, d, t = 16, 32, 0.1
    z1, z2 = _z(rng_np, b, d), _z(rng_np, b, d)
    got = float(tnt.ntxent_loss(torch.from_numpy(z1), torch.from_numpy(z2), t))
    want_xla = float(jnt.ntxent_loss(jnp.asarray(z1), jnp.asarray(z2), t))
    want_pallas = float(ntxent_loss_pallas(jnp.asarray(z1), jnp.asarray(z2),
                                           t, True))
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-6)


def test_logits_match_reference_layout(rng_np):
    z1, z2 = _z(rng_np, 5, 8), _z(rng_np, 5, 8)
    logits, labels = tnt.ntxent_logits(torch.from_numpy(z1),
                                       torch.from_numpy(z2), 0.5)
    jl, jlab = jnt.ntxent_logits(jnp.asarray(z1), jnp.asarray(z2), 0.5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlab))


def test_batched_forward_saves_lse_and_inv(rng_np):
    """Each problem of ntxent_problems is one ntxent_loss; lse and inv are
    the per-row logsumexp and inverse norm the kernel saves."""
    z = _z(rng_np, 3, 12, 16)
    loss, lse, inv = tnt.ntxent_problems(torch.from_numpy(z), 0.2)
    for p in range(3):
        want = float(jnt.ntxent_loss(jnp.asarray(z[p, :6]),
                                     jnp.asarray(z[p, 6:]), 0.2))
        np.testing.assert_allclose(float(loss[p]), want, rtol=1e-5)
    np.testing.assert_allclose(inv.numpy(), 1 / np.linalg.norm(z, axis=-1),
                               rtol=1e-6)
    assert lse.shape == (3, 12)


def test_analytic_backward_matches_pallas_vjp_and_autograd(rng_np):
    """The plain twin of K2b against jax.grad of the Pallas custom VJP, and
    against torch autograd through the plain forward, with a different
    upstream gradient per problem."""
    p, b, d, t = 3, 8, 16, 0.5
    z = _z(rng_np, p, 2 * b, d)
    g = rng_np.random(p).astype(np.float32) + 0.5
    zt = torch.from_numpy(z)
    _, lse, inv = tnt.ntxent_problems(zt, t)
    got = K.ntxent_backward_plain(zt, lse, inv, torch.from_numpy(g), t)

    for i in range(p):
        dz1, dz2 = jax.grad(
            lambda a, c: g[i] * ntxent_loss_pallas(a, c, t, True),
            argnums=(0, 1))(jnp.asarray(z[i, :b]), jnp.asarray(z[i, b:]))
        want = np.concatenate([np.asarray(dz1), np.asarray(dz2)])
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-4, atol=1e-6)

    zr = zt.clone().requires_grad_(True)
    (tnt.ntxent_problems(zr, t)[0] * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.numpy(), zr.grad.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_autograd_function_on_cpu_uses_analytic_backward(rng_np):
    z = torch.from_numpy(_z(rng_np, 2, 10, 8)).requires_grad_(True)
    loss = K.ntxent_problems_loss(z, 0.1)
    loss.sum().backward()
    zr = z.detach().clone().requires_grad_(True)
    tnt.ntxent_problems(zr, 0.1)[0].sum().backward()
    np.testing.assert_allclose(z.grad.numpy(), zr.grad.numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_loss_matches_jax(rng_np, groups):
    z1, z2 = _z(rng_np, 8, 16), _z(rng_np, 8, 16)
    got = float(tnt.grouped_ntxent_loss(torch.from_numpy(z1),
                                        torch.from_numpy(z2), 0.1, groups))
    want = float(jnt.grouped_ntxent_loss(jnp.asarray(z1), jnp.asarray(z2),
                                         0.1, groups))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _outputs(rng, b=8, d=16):
    return {
        "derm_z": _z(rng, 2 * b, d), "clinic_z": _z(rng, 2 * b, d),
        "cross_derm_z": (_z(rng, b, d), _z(rng, b, d)),
        "cross_clinic_z": (_z(rng, b, d), _z(rng, b, d)),
    }


@pytest.mark.parametrize("style", [0, 1, 2])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssl_loss_and_gradient_match_jax(rng_np, style, groups):
    outs = _outputs(rng_np)
    mw = (0.7, 1.3)
    t_outs = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(True),
                          outs)
    total, parts = ssl_loss(t_outs, style, 0.1, groups, modality_weights=mw)
    total.backward()

    def f(o):
        return jax_ssl_loss(o, style, 0.1, groups, modality_weights=mw)

    (want, want_parts), grads = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, outs))
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-5)
    for k in ("derm", "clinic", "cross"):
        np.testing.assert_allclose(float(parts[k].detach()),
                                   float(want_parts[k]), rtol=1e-5)
    for got_t, want_g in zip(jax.tree.leaves(t_outs), jax.tree.leaves(grads)):
        np.testing.assert_allclose(got_t.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-4, atol=1e-6)


def test_kernel_wrappers_take_a_projection_wider_than_512():
    """--proj-dim 640 is a loss in the reference; the port's shape check
    and both kernels' plans take it, and past what a block's shared memory
    holds the plans, not a register count, say no."""
    z = torch.zeros(8, 96, 640)
    K._check(z)
    assert K.ntxent_forward_plan(96, 640)["tiles"] == 2
    assert K.ntxent_backward_plan(96, 640)["tiles"] == 2
    assert not hasattr(K, "MAX_DIM")
    with pytest.raises(ValueError, match="shared memory"):
        K.ntxent_forward_plan(96, 4096)
    loss = K.ntxent_problems_loss(z.normal_(generator=torch.Generator()
                                            .manual_seed(0)), 0.1)
    assert loss.shape == (8,) and bool(torch.isfinite(loss).all())


def test_kernel_wrappers_refuse_cpu_tensors():
    z = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        K.ntxent_forward_cuda(z, 0.1)
    with pytest.raises(ValueError):
        K.ntxent_backward_cuda(z, torch.zeros(1, 4), torch.zeros(1, 4),
                               torch.zeros(1), 0.1)
