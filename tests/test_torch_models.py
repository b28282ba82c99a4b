"""The port's models (sm3x_torch.models) against the JAX package's Flax
models with shared weights, in float32 on the CPU.

Train mode: outputs at atol 1e-4, and the updated BN running statistics at
rtol 1e-5 (atol 1e-6 for means near zero). The running-variance check
catches the biased/unbiased trap: torch's own BatchNorm would be off by
n / (n - 1) there. Eval mode: outputs at atol 1e-4.

Train-mode BN over few values per channel amplifies float32 rounding layer
by layer. At ResNet-50's depth and a test-sized input the JAX package's own
float32 result lies up to ~2e-3 from a float64 evaluation of the same
network (the port's float32 result ~4e-4), so the checks first evaluate the
JAX model in float64 on the same weights and allow the port twice the JAX
float32 result's distance from it, never less than the tolerances above.
The float64 evaluation is the JAX package's, so a fault of the port cannot
widen its own tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.models.resnet import build_resnet as jax_build_resnet
from sm3x.models.simclr import build_ssl_model as jax_build_ssl_model
from sm3x_torch.models import backbones
from sm3x_torch.models.layers import BatchNorm
from sm3x_torch.models.resnet import build_resnet
from sm3x_torch.models.simclr import build_ssl_model
from sm3x_torch.utils import weights

torch.set_num_threads(2)


def _f64_noise(want, ref) -> float:
    """Twice the JAX float32 result's distance from the float64 one."""
    return 2 * float(np.abs(np.asarray(want, np.float64) - ref).max())


def _jax_f64(build, variables, *inputs):
    """The JAX model built by `build(dtype)` in float64 on the same weights,
    one train-mode forward: (outputs, updated batch_stats) as numpy."""
    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

    with jax.enable_x64(True):
        out, mut = build(jnp.float64).apply(
            f64(variables), *f64(inputs), train=True, mutable=["batch_stats"])
        return (jax.tree.map(np.asarray, out),
                jax.tree.map(np.asarray, mut["batch_stats"]))


def _check_stats(model, want_sd, ref_sd):
    """Running statistics after one train-mode forward; `ref_sd` holds the
    JAX model's statistics after the same forward in float64."""
    for k, t in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                t.numpy(), want_sd[k], rtol=1e-5,
                atol=max(1e-6, _f64_noise(want_sd[k], ref_sd[k])), err_msg=k)


# layer4 sees >= 8 values per channel (batch x its spatial size)
@pytest.mark.parametrize("arch,batch,size", [("resnet18", 8, 48),
                                             ("resnet50", 2, 64)])
def test_resnet_train_and_eval_match_jax(rng_np, arch, batch, size):
    jm = jax_build_resnet(arch, dtype=jnp.float32)
    x = rng_np.standard_normal((batch, size, size, 3)).astype(np.float32)
    v = jm.init(jax.random.key(0), jnp.asarray(x), train=False)
    sd = weights.to_tensors(weights.resnet_state_dict(v["params"],
                                                      v["batch_stats"]))
    model = build_resnet(arch)
    model.load_state_dict(sd, strict=True)

    want, mut = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    ref_out, ref_stats = _jax_f64(
        lambda dt: jax_build_resnet(arch, dtype=dt), v, x)
    model.train()
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=max(1e-4, _f64_noise(want, ref_out)))
    want_sd = weights.resnet_state_dict(v["params"], mut["batch_stats"])
    _check_stats(model, want_sd,
                 weights.resnet_state_dict(v["params"], ref_stats))

    # eval mode on the reference's updated statistics
    model.load_state_dict(weights.to_tensors(want_sd), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = jm.apply({"params": v["params"], "batch_stats": mut["batch_stats"]},
                    jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("version", ["v32", "v3"])
def test_simclr_skin_train_mode_matches_jax(rng_np, version):
    """Per-view encoder BN batches, the 2B intra projector batch and the
    per-view cross projector batches all update the same statistics."""
    b = 8  # cross projector BNs normalise over b values
    jm, style = jax_build_ssl_model(version, "resnet18", 16,
                                    dtype=jnp.float32)
    views = [rng_np.standard_normal((b, 48, 48, 3)).astype(np.float32)
             for _ in range(4)]
    jv = [jnp.asarray(a) for a in views]
    v = jm.init(jax.random.key(1), (jv[0], jv[1]), (jv[2], jv[3]),
                train=False)
    model, t_style = build_ssl_model(version, "resnet18", 16)
    assert t_style == style
    sd = weights.to_tensors(weights.simclr_skin_state_dict(
        v["params"], v["batch_stats"]))
    model.load_state_dict(sd, strict=True)

    want, mut = jm.apply(v, (jv[0], jv[1]), (jv[2], jv[3]), train=True,
                         mutable=["batch_stats"])
    ref_out, ref_stats = _jax_f64(
        lambda dt: jax_build_ssl_model(version, "resnet18", 16, dtype=dt)[0],
        v, (views[0], views[1]), (views[2], views[3]))
    tv = [torch.from_numpy(a) for a in views]
    got = model((tv[0], tv[1]), (tv[2], tv[3]))
    assert sorted(got) == sorted(want)

    def leaves(tree):
        return jax.tree.leaves(jax.tree.map(
            lambda t: np.asarray(t.detach().numpy() if torch.is_tensor(t)
                                 else t), tree))

    for g, w, r in zip(leaves(got), leaves(want), leaves(ref_out)):
        np.testing.assert_allclose(g, w, atol=max(1e-4, _f64_noise(w, r)))
    _check_stats(model, weights.simclr_skin_state_dict(
        v["params"], mut["batch_stats"]),
        weights.simclr_skin_state_dict(v["params"], ref_stats))


def test_batchnorm_running_var_is_biased():
    """BatchNorm moves running_var toward the biased batch variance, as Flax
    does; torch.nn.BatchNorm1d would use the unbiased one."""
    x = torch.randn(6, 3, generator=torch.Generator().manual_seed(0))
    bn = BatchNorm(3)
    y = bn(x)
    var = x.var(dim=0, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=0))
    ref = torch.nn.BatchNorm1d(3)
    torch.testing.assert_close(y, ref(x))
    assert int(bn.num_batches_tracked) == 1


def test_vit_backbones_point_at_the_roadmap():
    """The ViTs are ported, and what once pointed at the roadmap runs: a
    patch grid other than the one pos_embed was made for (resized,
    tests/test_torch_trainer_leftovers.py) and per-block remat of a
    ResNet."""
    vit = backbones.build_backbone("vit_t16", img_size=32)
    with torch.no_grad():
        assert vit(torch.zeros(1, 32, 32, 3)).shape == (1, 192)
        assert vit(torch.zeros(1, 64, 64, 3)).shape == (1, 192)
    assert backbones.build_backbone("resnet18", remat=True).remat is True
    assert backbones.build_backbone("resnet18").remat is False
    with pytest.raises(ValueError):
        backbones.build_backbone("resnet51")
