"""The stage-2 model of the port (sm3x_torch.models.transformer, projector,
mlc) against the JAX package on the same weights and numpy inputs, on the
CPU in float32 (TF32 does not exist there).

Weights are initialised in JAX, made non-trivial where Flax starts from
ones and zeros, carried across by `sm3x_torch.utils.weights.mlc_state_dict`
and loaded strictly. Tolerances: rtol 1e-5 / atol 1e-6 for the transformer
layer and the projectors alone (sums in another order); rtol 1e-4 / atol
1e-5 through the two ResNet-18 encoders at 56x56, the tolerance
tests/test_torch_models.py holds the encoders to. Dropout draws differ
between the frameworks, so train-mode outputs are compared at dropout 0,
and at rtol / atol 1e-3: batch norm over the 4 rows of the test's batch
divides by a batch deviation that can be small, in every encoder layer and
again in the heads of v1-v3, which magnifies float32 rounding (measured:
2 of 1024 entries of `sa` off by up to 2.1e-4 with v2; `sa` is
layer-normed, of order 1).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import sm3x
import sm3x_torch
from sm3x.models.mlc import MLCModel as JaxMLCModel
from sm3x.models.projector import MultiLabelProjector as JaxProjector
from sm3x.models.transformer import TransformerEncoderLayer as JaxLayer
from sm3x.utils import torch_export
from sm3x_torch.models.mlc import MLCModel, Prototypes
from sm3x_torch.models.projector import MultiLabelProjector
from sm3x_torch.models.transformer import TransformerEncoderLayer, dropout
from sm3x_torch.utils import weights

torch.set_num_threads(2)

TIGHT = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)


def _randomise(tree, rng, low=0.5, high=1.5):
    """Every leaf moved off its initial ones and zeros; variances and
    scales stay positive."""
    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("var", "scale"):
            return rng.uniform(low, high, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_task_constants_equal_the_jax_package():
    for name in ("NUM_CLASSES", "CLASSES_NAME", "CLS_WEIGHTS", "METRICS_NAME"):
        assert getattr(sm3x_torch, name) == getattr(sm3x, name), name
    assert len(sm3x_torch.NUM_CLASSES) == 8


@pytest.mark.parametrize("n_heads", [1, 2])
def test_transformer_layer_matches_jax(rng_np, n_heads):
    s, b, d, ff = 8, 5, 32, 16
    x = rng_np.standard_normal((s, b, d)).astype(np.float32)
    jl = JaxLayer(d, n_heads, ff, dropout=0.1)
    params = jl.init(jax.random.key(1), jnp.asarray(x))["params"]
    params = _randomise(_np_tree(params), rng_np)
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x),
                               deterministic=True))
    layer = TransformerEncoderLayer(d, n_heads, ff, dropout=0.1)
    sd = weights.transformer_layer_state_dict(params, "")
    assert set(sd) == set(torch_export.export_transformer_layer(params, ""))
    layer.load_state_dict(weights.to_tensors(sd), strict=True)
    layer.eval()
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TIGHT)
    # dropout at p = 0 in train mode is the same function
    layer.train()
    layer.dropout = layer.self_attn.dropout = 0.0
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(),
                               want, **TIGHT)


def test_dropout_draws_from_the_generator():
    x = torch.ones(64, 64)
    a = dropout(x, 0.25, True, torch.Generator().manual_seed(5))
    b = dropout(x, 0.25, True, torch.Generator().manual_seed(5))
    c = dropout(x, 0.25, True, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.unique().tolist() == pytest.approx([0.0, 1.0 / 0.75])
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.03
    assert dropout(x, 0.25, False) is x and dropout(x, 0.0, True) is x


@pytest.mark.parametrize("variant", ["v0", "v1", "v2", "v3", "v4"])
def test_multilabel_projector_matches_jax(rng_np, variant):
    """Eval output from the running statistics, then a train-mode call:
    its output and the statistics it leaves (Flax's biased variance)."""
    b, in_dim, proj = 6, 24, 12
    x = rng_np.standard_normal((b, in_dim)).astype(np.float32)
    jp = JaxProjector(in_dim, proj, 8, variant)
    v = jp.init(jax.random.key(2), jnp.asarray(x), False)
    params = _randomise(_np_tree(v.get("params", {})), rng_np)
    stats = _randomise(_np_tree(v.get("batch_stats", {})), rng_np)
    variables = {"params": params, "batch_stats": stats}
    port = MultiLabelProjector(in_dim, proj, 8, variant)
    sd = weights.multilabel_projector_state_dict(params, stats, variant)
    if variant != "v0":
        want_sd = torch_export.export_multilabel_projector(params, stats,
                                                           variant)
        assert list(sorted(sd)) == list(sorted(want_sd))
        for k in sd:
            np.testing.assert_array_equal(sd[k], want_sd[k])
    port.load_state_dict(weights.to_tensors(sd), strict=True)

    want = np.asarray(jp.apply(variables, jnp.asarray(x), False))
    port.eval()
    got = port(torch.from_numpy(x))
    assert got.shape == ((1, b, in_dim) if variant == "v0" else (8, b, proj))
    np.testing.assert_allclose(got.detach().numpy(), want, **TIGHT)

    want, mut = jp.apply(variables, jnp.asarray(x), True,
                         mutable=["batch_stats"])
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    new_sd = weights.multilabel_projector_state_dict(
        params, _np_tree(mut.get("batch_stats", {})), variant)
    have = port.state_dict()
    for k, v_ in new_sd.items():
        if "running" in k:
            np.testing.assert_allclose(have[k].numpy(), v_, **TIGHT,
                                       err_msg=k)


def _jax_model(variant, bias, proj_dim=32, dropout=0.0, l2_norm=False):
    return JaxMLCModel(arch="resnet18", proj_dim=proj_dim, mlc_proj=variant,
                       sa_dim_ff=16, sa_dropout=dropout, l2_norm=l2_norm,
                       use_prototype_bias=bias, dtype=jnp.float32)


def _init(jm, rng, size=56):
    x = jnp.zeros((2, size, size, 3), jnp.float32)
    v = jm.init({"params": jax.random.key(3), "dropout": jax.random.key(4)},
                x, x, extractor_train=False, head_train=False)
    return (_randomise(_np_tree(v["params"]), rng, 0.8, 1.2),
            _randomise(_np_tree(v["batch_stats"]), rng, 0.8, 1.2))


def _port_model(variant, bias, sd, proj_dim=32, l2_norm=False):
    model = MLCModel("resnet18", proj_dim=proj_dim, mlc_proj=variant,
                     sa_dim_ff=16, sa_dropout=0.0, l2_norm=l2_norm,
                     use_prototype_bias=bias)
    model.load_state_dict(weights.to_tensors(sd), strict=True)
    return model


@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4"])
def test_mlc_state_dict_equals_export_mlc_model(rng_np, variant):
    params, stats = _init(_jax_model(variant, True), rng_np)
    got = weights.mlc_state_dict(params, stats, variant)
    want = torch_export.export_mlc_model(params, stats, "resnet18", variant)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("variant,bias,l2_norm", [
    ("v4", False, False),   # the train variant of run.sh
    ("v4", True, False),    # the eval variant: prototypes with a bias
    ("v4", False, True),    # --l2-norm
    ("v2", False, False),   # batch norm in the heads
    ("v0", False, False),   # the identity: one pseudo-head feeds all labels
])
def test_mlc_model_matches_jax(rng_np, variant, bias, l2_norm):
    """`sa` and `preds` in eval mode, then with every module in train mode
    (batch statistics; dropout 0) and the running statistics that leaves."""
    proj_dim = 1024 if variant == "v0" else 32
    jm = _jax_model(variant, bias, proj_dim, l2_norm=l2_norm)
    params, stats = _init(jm, rng_np)
    model = _port_model(variant, bias,
                        weights.mlc_state_dict(params, stats, variant),
                        proj_dim, l2_norm)
    d, c = (rng_np.standard_normal((4, 56, 56, 3)).astype(np.float32)
            for _ in range(2))
    variables = {"params": params, "batch_stats": stats}

    sa_w, preds_w = jm.apply(variables, jnp.asarray(d), jnp.asarray(c))
    sa, preds = model(torch.from_numpy(d), torch.from_numpy(c))
    assert not model.extractor.training and not model.mlc_sa.training
    assert sa.shape == sa_w.shape and len(preds) == 8
    np.testing.assert_allclose(sa.detach().numpy(), np.asarray(sa_w), **MODEL)
    for got, want, k in zip(preds, preds_w, sm3x_torch.NUM_CLASSES):
        assert got.shape == (4, k)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **MODEL)

    (sa_w, preds_w), mut = jm.apply(
        variables, jnp.asarray(d), jnp.asarray(c), extractor_train=True,
        head_train=True, mutable=["batch_stats"])
    sa, preds = model(torch.from_numpy(d), torch.from_numpy(c),
                      extractor_train=True, head_train=True)
    assert model.extractor.training and model.projectors.training
    assert not sa.requires_grad or sa.grad_fn is not None
    np.testing.assert_allclose(sa.detach().numpy(), np.asarray(sa_w),
                               rtol=1e-3, atol=1e-3)
    want_sd = weights.mlc_state_dict(params, _np_tree(mut["batch_stats"]),
                                     variant)
    have = model.state_dict()
    for k, v in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(have[k].numpy(), v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_stop_extractor_grad_cuts_the_backward(rng_np):
    model = MLCModel("resnet18", proj_dim=32, sa_dim_ff=16)
    x = torch.from_numpy(rng_np.standard_normal((2, 56, 56, 3))
                         .astype(np.float32))
    sa, preds = model(x, x, head_train=True)
    sum(p.sum() for p in preds).backward()
    assert model.extractor.derm_backbone.encoder.conv1.weight.grad is None
    assert model.prototypes[0].weight.grad is not None
    sa, preds = model(x, x, extractor_train=True, head_train=True,
                      stop_extractor_grad=False)
    sum(p.sum() for p in preds).backward()
    assert model.extractor.derm_backbone.encoder.conv1.weight.grad is not None


def test_prototypes_variants():
    train = Prototypes(32)
    assert [h.out_features for h in train] == sm3x_torch.NUM_CLASSES
    assert all(h.bias is None for h in train)
    assert float(train[0].weight.detach().abs().max()) <= 1 / 32 ** 0.5
    torch.manual_seed(0)
    evalv = Prototypes(512, use_bias=True)
    assert all(float(h.bias.detach().abs().max()) == 0 for h in evalv)
    assert 0.005 < float(torch.cat([h.weight.detach().flatten() for h in evalv]).std()) < 0.02
    # one pseudo-head feeds every label
    preds = train(torch.zeros(1, 3, 32))
    assert [p.shape for p in preds] == [(3, k) for k in sm3x_torch.NUM_CLASSES]
