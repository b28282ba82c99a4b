"""The model variants no CLI reaches, the dormant layers and the uint8
normalisation of the port against the JAX package, on the CPU: `SimCLR`'s
logits, `SimCLRSkin`, every `SimCLRSkinV2` fusion (concat, concat_cross,
concat_both, add), `ConvWS`, `ConvAWS`, `group_norm`, `normalize_uint8` /
`denormalize_to_uint8`; each on weights carried over by
`sm3x_torch.utils.weights` (strict loads) and inputs made with numpy.

The models run resnet18 at 32x32, B = 4, in train mode (each view its own
batch-norm batch); at B = 4 the last stages' batch norms normalise over 4
values, where float32 rounding alone moves the outputs by ~1e-4
(tests/test_torch_multicrop.py), so both sides compute in float64
(`jax.enable_x64`, un-jitted), held at rtol 1e-4 / atol 1e-5; the running
statistics they move at atol 1e-6. The layers run in float32 at rtol 1e-4
/ atol 1e-5; the normalisation round trip is exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.models import layers as jax_layers
from sm3x.models import simclr as jax_simclr
from sm3x.ops import augment as jax_augment
from sm3x_torch.models import layers, simclr
from sm3x_torch.ops import augment as A
from sm3x_torch.utils import weights

torch.set_num_threads(2)

B, SIZE, PROJ = 4, 32, 16
TOL = dict(rtol=1e-4, atol=1e-5)


def _views(n=4):
    return np.random.default_rng(3407).standard_normal(
        (n, B, SIZE, SIZE, 3))


def _jax_run(jm, *args):
    """init and one train-mode apply in float64: (params, stats, outputs,
    the batch statistics after the apply)."""
    x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float64)
    init_args = [(x, x) if isinstance(a, tuple) else x for a in args]
    v = jm.init(jax.random.key(0), *init_args, train=False)
    out, mut = jm.apply(v, *args, train=True, mutable=["batch_stats"])
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return (to_np(v["params"]), to_np(v["batch_stats"]), to_np(out),
            to_np(mut["batch_stats"]))


def _port(model, sd):
    model.load_state_dict(weights.to_tensors(sd), strict=True)
    return model.double().train()


def _close(got, want, **tol):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, **tol)
        return
    np.testing.assert_allclose(got.detach().numpy(), want, **(tol or TOL))


def _stats_moved_alike(model, sd_after):
    for k, buf in model.named_buffers():
        if "running" in k:
            np.testing.assert_allclose(buf.numpy(), sd_after[k], atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("fusion", ["concat", "concat_cross", "concat_both",
                                    "add"])
def test_simclr_skin_v2_fusions_match_jax(fusion):
    v = _views()
    with jax.enable_x64(True):
        jm = jax_simclr.SimCLRSkinV2(arch="resnet18", proj_dim=PROJ,
                                     fusion=fusion, dtype=jnp.float64)
        x = [jnp.asarray(a) for a in v]
        params, stats, out, after = _jax_run(jm, (x[0], x[1]), (x[2], x[3]))
    model = _port(simclr.SimCLRSkinV2("resnet18", PROJ, fusion),
                  weights.simclr_skin_v2_state_dict(params, stats))
    t = [torch.from_numpy(a) for a in v]
    got = model((t[0], t[1]), (t[2], t[3]))
    assert sorted(got) == sorted(out) == ["clinic_z", "cross_z", "derm_z"]
    assert len(got["cross_z"]) == (2 if fusion == "concat_both" else 1)
    assert got["cross_z"][0].shape == (2 * B, PROJ)
    for k in out:
        _close(got[k], out[k])
    _stats_moved_alike(model, weights.simclr_skin_v2_state_dict(params,
                                                                after))
    width = model.cross_proj[0].weight.shape[1]
    assert width == (512 if fusion == "add" else 1024)


def test_simclr_logits_match_jax():
    v = _views(2)
    with jax.enable_x64(True):
        jm = jax_simclr.SimCLR(arch="resnet18", proj_dim=PROJ,
                               temperature=0.5, dtype=jnp.float64)
        x = [jnp.asarray(a) for a in v]
        params, stats, (logits, labels), after = _jax_run(jm, x[0], x[1])
    model = _port(simclr.SimCLR("resnet18", PROJ, 0.5),
                  weights.simclr_state_dict(params, stats))
    got_logits, got_labels = model(*(torch.from_numpy(a) for a in v))
    assert got_logits.shape == logits.shape == (2 * B, 2 * B - 1)
    _close(got_logits, logits)
    np.testing.assert_array_equal(got_labels.numpy(), labels)
    _stats_moved_alike(model, weights.simclr_state_dict(params, after))
    assert model.extract(torch.from_numpy(v[0])).shape == (B, 512)


def test_simclr_skin_matches_jax():
    v = _views()
    with jax.enable_x64(True):
        jm = jax_simclr.SimCLRSkin(arch="resnet18", proj_dim=PROJ,
                                   dtype=jnp.float64)
        x = [jnp.asarray(a) for a in v]
        params, stats, out, after = _jax_run(jm, (x[0], x[1]), (x[2], x[3]))
    model = _port(simclr.SimCLRSkin("resnet18", PROJ),
                  weights.simclr_skin_plain_state_dict(params, stats))
    t = [torch.from_numpy(a) for a in v]
    got = model((t[0], t[1]), (t[2], t[3]))
    assert sorted(got) == sorted(out) == ["clinic_z", "derm_z"]
    for k in out:
        _close(got[k], out[k])
    _stats_moved_alike(model, weights.simclr_skin_plain_state_dict(params,
                                                                   after))


def test_unknown_fusion_is_refused():
    with pytest.raises(ValueError, match="unknown fusion"):
        simclr.SimCLRSkinV2("resnet18", PROJ, "mean")


@pytest.mark.parametrize("kind,strides,kernel", [
    ("ws", 1, (3, 3)), ("ws", 2, (3, 3)), ("aws", 1, (3, 3)),
    ("aws", 2, (1, 1))])
def test_weight_standardised_convs_match_jax(kind, strides, kernel):
    """NCHW in the port, NHWC in Flax; the kernel standardised with the
    biased std (jnp.std's), the adaptive scale and shift applied after."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    jcls = jax_layers.ConvWS if kind == "ws" else jax_layers.ConvAWS
    jm = jcls(features=6, kernel=kernel, strides=strides)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, v["params"])
    params["bias"] = rng.standard_normal(6).astype(np.float32)
    if kind == "aws":
        params["ws_gamma"] = rng.standard_normal((1, 1, 1, 6)).astype(
            np.float32)
        params["ws_beta"] = 0.1 * rng.standard_normal((1, 1, 1, 6)).astype(
            np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tcls = layers.ConvWS if kind == "ws" else layers.ConvAWS
    tm = tcls(4, 6, kernel, strides)
    tm.load_state_dict(weights.to_tensors(weights.conv_ws_state_dict(params)),
                       strict=True)
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # the kernel in use has zero mean and unit biased std a channel
    ws = layers.ConvWS.standardised(tm).detach().double()
    np.testing.assert_allclose(ws.mean(dim=(1, 2, 3)).numpy(), 0, atol=1e-6)
    np.testing.assert_allclose(
        ws.std(dim=(1, 2, 3), unbiased=False).numpy(), 1, rtol=1e-4)


def test_conv_init_is_he_normal_over_fan_out():
    torch.manual_seed(0)
    w = layers.ConvWS(64, 256, (3, 3)).weight.detach()
    np.testing.assert_allclose(float(w.std()), np.sqrt(2 / (256 * 9)),
                               rtol=2e-2)


@pytest.mark.parametrize("groups", [2, 4])
def test_group_norm_matches_jax(groups):
    rng = np.random.default_rng(2)
    x = (3 + 2 * rng.standard_normal((2, 5, 5, 8))).astype(np.float32)
    jgn = jax_layers.group_norm(num_groups=groups)
    v = jgn.init(jax.random.key(0), jnp.asarray(x))
    scale = rng.standard_normal(8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    want = np.asarray(jgn.apply({"params": {"scale": scale, "bias": bias}},
                                jnp.asarray(x)))
    tgn = layers.group_norm(8, num_groups=groups)
    assert tgn.eps == jgn.epsilon == 1e-6
    tgn.load_state_dict({"weight": torch.from_numpy(scale),
                         "bias": torch.from_numpy(bias)})
    got = tgn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert v["params"]["scale"].shape == (8,)


def test_normalize_uint8_matches_jax_and_round_trips():
    mean, std = (0.7833, 0.6712, 0.6026), (0.2139, 0.2472, 0.2571)
    x = np.random.default_rng(4).integers(0, 256, (3, 7, 5, 3),
                                          dtype=np.uint8)
    got = A.normalize_uint8(x, mean, std)
    want = np.asarray(jax_augment.normalize_uint8(x, mean, std))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    back = A.denormalize_to_uint8(got, mean, std)
    want_back = np.asarray(jax_augment.denormalize_to_uint8(want, mean, std))
    np.testing.assert_array_equal(back.numpy(), want_back)
    # uint8 -> normalised -> uint8 gives each value back (the float32
    # round trip lands within a rounding of the integer: truncation may
    # take one off, as it does in the JAX package)
    assert np.abs(back.numpy().astype(int) - x).max() <= 1
    np.testing.assert_array_equal(back.numpy(), want_back)
    # out of range values are clipped
    clipped = A.denormalize_to_uint8(torch.tensor([[-10.0, 10.0, 0.0]]),
                                     mean, std)
    assert clipped.tolist()[0][:2] == [0, 255]
