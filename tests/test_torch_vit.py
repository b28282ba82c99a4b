"""The port's ViT (sm3x_torch.models.vit) against the JAX package's Flax ViT
(sm3x/models/vit.py) with shared weights, in float32 on the CPU, at a cut
size: dim 128, depth 2, 2 heads (head dim 64, the kernels' width), patch
16, 32x32 inputs.

* forward at atol 1e-4;
* gradients of every ported --use-checkpoint mode against the JAX
  package's un-checkpointed ViT, at the tolerances of the JAX package's own
  mode test (rtol 2e-4, atol 2e-5, tests/test_vit_trimodal.py:46). The
  loss is a fixed random projection of the features, and the reference is
  the JAX ViT evaluated in float64 on the same weights: that test's
  sum(f^2) of a LayerNorm output is nearly constant, so its float32
  gradients are rounding noise (the JAX package's own float32 gradient of
  `cls` lies 9% from its float64 one), while under the projection both
  frameworks' float32 gradients lie within half the bound of float64;
* the parity traps: gelu with the tanh approximation, LayerNorm eps 1e-6,
  the float32 cls feature, Flax's initialisers;
* `vit_state_dict` loading strictly, and the registry's errors.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sm3x.models import vit as jax_vit
from sm3x.models.backbones import build_backbone as jax_build_backbone
from sm3x_torch.models import backbones
from sm3x_torch.models.vit import ViT, ViTBlock
from sm3x_torch.utils import weights

torch.set_num_threads(2)

CUT = dict(patch=16, dim=128, depth=2, n_heads=2)
SIZE = 32


@pytest.fixture(scope="module")
def jax_model():
    x = np.random.default_rng(0).standard_normal(
        (3, SIZE, SIZE, 3)).astype(np.float32)
    m = jax_vit.ViT(dtype=jnp.float32, **CUT)
    params = m.init(jax.random.key(0), jnp.asarray(x))["params"]
    return m, params, x


@pytest.fixture(scope="module")
def jax_grads(jax_model):
    """Projection weights and the float64 JAX gradient of the projected
    features, in the port's key layout."""
    _, params, x = jax_model
    proj = np.random.default_rng(9).standard_normal(
        (3, CUT["dim"])).astype(np.float32)
    with jax.enable_x64(True):
        m64 = jax_vit.ViT(dtype=jnp.float64, **CUT)
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)

        def loss(p):
            return jnp.sum(m64.apply({"params": p},
                                     jnp.asarray(x, jnp.float64)) * proj)

        grads = jax.device_get(jax.grad(loss)(p64))
    return proj, {k: np.asarray(v, np.float64) for k, v in
                  weights.vit_state_dict(grads).items()}


def _port(params, remat=False):
    model = ViT(remat=remat, img_size=SIZE, **CUT)
    model.load_state_dict(weights.to_tensors(weights.vit_state_dict(params)),
                          strict=True)
    return model


def test_forward_matches_jax(jax_model):
    m, params, x = jax_model
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, CUT["dim"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("remat", [False, True, "dots", "attn", "flash",
                                   "mlp", "attn_mlp"])
def test_gradients_match_jax_in_every_mode(jax_model, jax_grads, remat):
    _, params, x = jax_model
    proj, want = jax_grads
    model = _port(params, remat)
    (model(torch.from_numpy(x)) * torch.from_numpy(proj)).sum().backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=2e-4,
                                   atol=2e-5, err_msg=f"{remat}: {name}")


def test_gelu_is_the_tanh_approximation_and_layernorm_eps_is_flax():
    x = np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32)
    t = torch.from_numpy(x)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(F.gelu(t, approximate="tanh").numpy(), want,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(t).numpy() - want).max() > 1e-4  # erf differs

    blk = ViTBlock(64, 1)
    for ln in (blk.ln1, blk.ln2):
        assert ln.eps == 1e-6
    # ln2 + fc1 + gelu against Flax on features of tiny variance, where
    # torch's default eps (1e-5) would move the result
    small = x * 1e-3
    flax_ln = fnn.LayerNorm(epsilon=1e-6)
    ln_out = flax_ln.apply({"params": {"scale": jnp.ones(64),
                                       "bias": jnp.zeros(64)}},
                           jnp.asarray(small))
    w = blk.fc1.weight.detach().numpy()
    b = blk.fc1.bias.detach().numpy()
    want = np.asarray(fnn.gelu(ln_out @ w.T + b))
    with torch.no_grad():
        got = blk.mlp_in(torch.from_numpy(small)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        eps5 = F.gelu(blk.fc1(F.layer_norm(torch.from_numpy(small), (64,),
                                           eps=1e-5)), approximate="tanh")
    assert np.abs(eps5.numpy() - want).max() > 1e-2


def test_feature_is_the_float32_cls_token_under_autocast():
    model = ViT(img_size=SIZE, **CUT)
    x = torch.randn(2, SIZE, SIZE, 3)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        feat = model(x)
    assert feat.dtype == torch.float32 and feat.shape == (2, CUT["dim"])


def test_state_dict_bridge_loads_strictly():
    m = jax_build_backbone("vit_t16", num_classes=5, dtype=jnp.float32)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    params = m.init(jax.random.key(1), x)["params"]
    sd = weights.vit_state_dict(params, prefix="enc.")
    assert sd["enc.block11.attn.query.weight"].shape == (192, 192)
    assert sd["enc.block0.attn.out.weight"].shape == (192, 192)
    assert sd["enc.pos_embed"].shape == (1, 5, 192)
    model = backbones.build_backbone("vit_t16", num_classes=5, img_size=SIZE)
    model.load_state_dict(weights.to_tensors(
        {k[len("enc."):]: v for k, v in sd.items()}), strict=True)
    with torch.no_grad():
        got = model(torch.zeros(1, SIZE, SIZE, 3)).numpy()
    np.testing.assert_allclose(got, np.asarray(m.apply({"params": params}, x)),
                               atol=1e-4)


def test_registry_and_its_errors():
    assert [backbones.feat_dim(a) for a in ("vit_t16", "vit_s16", "vit_b16",
                                            "vit_l16")] == [192, 384, 768,
                                                            1024]
    for mode in ("attn", "flash", "dots", "mlp", "attn_mlp"):
        with pytest.raises(ValueError, match="attention-memory mode"):
            backbones.build_backbone("resnet18", remat=mode)
        with pytest.raises(ValueError, match="attention-memory mode"):
            jax_build_backbone("resnet18", remat=mode)  # the same refusal
    for mode in ("flsh", "off"):  # "off" is the trainer's, as in JAX
        with pytest.raises(ValueError, match="unknown remat"):
            backbones.build_backbone("vit_t16", remat=mode, img_size=SIZE)
        with pytest.raises(ValueError, match="unknown remat"):
            jax_vit.build_vit("vit_t16", dtype=jnp.float32, remat=mode).init(
                jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    with pytest.raises(ValueError, match="unknown backbone"):
        backbones.build_backbone("vit_x16")


def test_initialisation_follows_flax(jax_model):
    """Each parameter's spread and range against the JAX package's init of
    the same ViT (lecun-normal patch embed and attention, normal(0.02) cls
    and pos_embed, torch-linear fc1 / fc2, zero biases, unit LN scales)."""
    _, params, _ = jax_model
    want = weights.vit_state_dict(params)
    torch.manual_seed(0)
    model = ViT(img_size=SIZE, **CUT)
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name]
        if name.endswith("bias") or "ln" in name:
            np.testing.assert_array_equal(got, ref, err_msg=name)
            continue
        assert abs(got.std() / ref.std() - 1) < 0.15, name
        assert abs(got.mean()) < 3 * ref.std() / np.sqrt(got.size) + 1e-3
    fan_in = 3 * 16 * 16
    bound = 2 * np.sqrt(1 / fan_in) / 0.87962566103423978
    assert np.abs(model.patch_embed.weight.detach().numpy()).max() <= bound
    fc1 = model.block0.fc1.weight.detach().numpy()
    assert np.abs(fc1).max() <= 1 / np.sqrt(CUT["dim"])
