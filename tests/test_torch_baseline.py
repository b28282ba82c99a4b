"""The supervised baselines and evaluators of the port
(sm3x_torch.models.baseline, evaluator) against the JAX package on the same
weights and numpy inputs, on the CPU in float32.

Weights are initialised in JAX (the heads N(0, 0.01), zero bias), made
non-trivial where Flax starts from ones and zeros, carried across by
`sm3x_torch.utils.weights.baseline_state_dict` and loaded strictly. Sizes:
resnet18, 32x32, batch 8. Outputs are held at atol 1e-4 (rtol 1e-4): the
heads' weights are of order 0.01, so the logits are small and the features
behind them are compared at about 1e-2 relative to that bound; the eval
features themselves at the encoders' rtol 1e-4 / atol 1e-5. Batch-norm
statistics after a train-mode call at rtol 1e-4 / atol 1e-5. Dropout draws
differ between the frameworks, so variant 2 is compared in eval mode and its
train mode is checked for what dropout does. kNN votes are exact; scores at
rtol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x import NUM_CLASSES
from sm3x.models import baseline as jb
from sm3x.models import evaluator as je
from sm3x_torch.models import baseline as pb
from sm3x_torch.models import evaluator as pe
from sm3x_torch.utils import weights

torch.set_num_threads(2)

B, SIZE = 8, 32
OUT = dict(rtol=1e-4, atol=1e-4)
STAT = dict(rtol=1e-4, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _randomise(tree, rng):
    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _inputs(rng):
    return (rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32),
            rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32))


def _running(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}


@pytest.mark.parametrize("mlp_variant", [None, 1, 2, 3])
def test_baseline_matches_jax(rng_np, mlp_variant):
    d, c = _inputs(rng_np)
    jm = jb.Baseline(arch="resnet18", mlp_variant=mlp_variant,
                     dtype=jnp.float32)
    v = jm.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                jnp.asarray(d), jnp.asarray(c), train=False)
    params = _randomise(_np_tree(v["params"]), rng_np)
    stats = _randomise(_np_tree(v["batch_stats"]), rng_np)
    variables = {"params": params, "batch_stats": stats}

    model = pb.Baseline("resnet18", mlp_variant=mlp_variant)
    sd = weights.baseline_state_dict(params, stats)
    model.load_state_dict(weights.to_tensors(sd), strict=True)
    heads = [k for k in sd if k.startswith("classifier.")]
    assert len(heads) == 8 * {None: 2, 1: 4, 2: 4, 3: 9}[mlp_variant]
    td, tc = torch.from_numpy(d), torch.from_numpy(c)

    # eval: running statistics, no dropout
    want = jm.apply(variables, jnp.asarray(d), jnp.asarray(c), train=False)
    got = model(td, tc)
    assert not model.derm_backbone.training and len(got) == 8
    for g, w, n in zip(got, want, NUM_CLASSES):
        assert g.shape == (B, n)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **OUT)
    fd, fc = model.extract(td, tc)
    wd, wc = jm.apply(variables, jnp.asarray(d), jnp.asarray(c),
                      method=jm.extract)
    np.testing.assert_allclose(fd.detach().numpy(), np.asarray(wd),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fc.detach().numpy(), np.asarray(wc),
                               rtol=1e-4, atol=1e-5)

    if mlp_variant == 2:
        # dropout 0.5 from the generator: seeded, and half the hidden units
        a = model(td, tc, train=True, generator=torch.Generator().manual_seed(1))
        b = model(td, tc, train=True, generator=torch.Generator().manual_seed(1))
        e = model(td, tc, train=True, generator=torch.Generator().manual_seed(2))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not all(torch.equal(x, y) for x, y in zip(a, e))
        return
    # train: batch statistics, and the running statistics they leave
    before = _running(model)
    want, mut = jm.apply(variables, jnp.asarray(d), jnp.asarray(c),
                         train=True, mutable=["batch_stats"],
                         rngs={"dropout": jax.random.key(2)})
    got = model(td, tc, train=True)
    assert model.derm_backbone.training
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **OUT)
    after = _running(model)
    assert all(not torch.equal(before[k], after[k]) for k in before)
    new_sd = weights.baseline_state_dict(params, _np_tree(mut["batch_stats"]))
    for k, val in after.items():
        np.testing.assert_allclose(val.numpy(), new_sd[k], **STAT, err_msg=k)


def test_baseline_stop_backbone_grad_cuts_the_backward(rng_np):
    d, c = (torch.from_numpy(x) for x in _inputs(rng_np))
    model = pb.Baseline("resnet18")
    sum(p.sum() for p in model(d, c, train=False,
                               stop_backbone_grad=True)).backward()
    assert model.derm_backbone.conv1.weight.grad is None
    assert model.classifier[0].weight.grad is not None
    sum(p.sum() for p in model(d, c, train=True)).backward()
    assert model.derm_backbone.conv1.weight.grad is not None


def test_head_initialisation():
    torch.manual_seed(0)
    model = pb.Baseline("resnet18", mlp_variant=1)
    w = torch.cat([h.fc1.weight.flatten() for h in model.classifier])
    assert abs(float(w.std()) - 0.01) < 5e-4 and abs(float(w.mean())) < 1e-4
    assert all(float(h.fc2.bias.abs().max()) == 0 for h in model.classifier)
    heads = pb.MultiHeadClassifier(64)
    assert [h.out_features for h in heads] == list(NUM_CLASSES)
    assert sorted(heads.state_dict())[:2] == ["0.bias", "0.weight"]


def test_timm_arch_is_refused_as_in_the_jax_package():
    with pytest.raises(ValueError, match="timm arch"):
        pb.Baseline("timm_resnet50")
    jm = jb.Baseline(arch="timm_resnet50")
    x = jnp.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match="timm arch"):
        jm.init(jax.random.key(0), x, x)


def test_single_baseline_matches_jax(rng_np):
    d, _ = _inputs(rng_np)
    jm = jb.SingleBaseline(arch="resnet18", dtype=jnp.float32)
    v = jm.init(jax.random.key(0), jnp.asarray(d), train=False)
    params = _randomise(_np_tree(v["params"]), rng_np)
    stats = _randomise(_np_tree(v["batch_stats"]), rng_np)
    model = pb.SingleBaseline("resnet18")
    model.load_state_dict(weights.to_tensors(
        weights.baseline_state_dict(params, stats)), strict=True)
    for train in (False, True):
        want = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(d), train=train, mutable=["batch_stats"])[0]
        got = model(torch.from_numpy(d), train=train)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **OUT)


def test_multihead_classifier_and_evaluator_match_jax(rng_np):
    x = rng_np.standard_normal((B, 48)).astype(np.float32)
    jm = jb.MultiHeadClassifier()
    params = _np_tree(jm.init(jax.random.key(3), jnp.asarray(x))["params"])
    params = _randomise(params, rng_np)
    heads = pb.MultiHeadClassifier(48)
    sd = weights.baseline_state_dict({"classifier": params}, {})
    assert sorted(sd) == sorted(f"classifier.{i}.{n}" for i in range(8)
                                for n in ("weight", "bias"))
    heads.load_state_dict({k[len("classifier."):]: torch.from_numpy(v)
                           for k, v in sd.items()}, strict=True)
    want = jm.apply({"params": params}, jnp.asarray(x))
    for g, w in zip(heads(torch.from_numpy(x)), want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    assert pe.LogisticRegressMultiHeadEvaluator is pb.MultiHeadClassifier

    je_model = je.LogisticRegressEvaluator(5)
    p = _np_tree(je_model.init(jax.random.key(4), jnp.asarray(x))["params"])
    probe = pb.LogisticRegressEvaluator(48, 5)
    probe.load_state_dict({
        "classifier.weight": torch.from_numpy(p["classifier"]["kernel"].T.copy()),
        "classifier.bias": torch.from_numpy(p["classifier"]["bias"].copy())})
    np.testing.assert_allclose(
        probe(torch.from_numpy(x)).detach().numpy(),
        np.asarray(je_model.apply({"params": p}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_knn_predict_matches_jax(rng_np):
    n, b, dim, classes, k = 60, 9, 16, 4, 7
    bank = _unit(rng_np.standard_normal((n, dim))).astype(np.float32)
    query = _unit(rng_np.standard_normal((b, dim))).astype(np.float32)
    labels = rng_np.integers(0, classes, n).astype(np.int32)
    want = np.asarray(je.knn_predict(jnp.asarray(query), jnp.asarray(bank),
                                     jnp.asarray(labels), classes, k, 0.07))
    got = pe.knn_predict(torch.from_numpy(query), torch.from_numpy(bank),
                         torch.from_numpy(labels), classes, k, 0.07)
    assert got.shape == (b, classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(got.argmax(1).numpy(), want.argmax(1))


def test_knn_eval_matches_jax(rng_np):
    classes, dim = 3, 8
    centres = 4 * rng_np.standard_normal((classes, dim))

    def split(n):
        y = rng_np.integers(0, classes, n)
        x = (centres[y] + rng_np.standard_normal((n, dim))).astype(np.float32)
        return [(x[i:i + 10], y[i:i + 10]) for i in range(0, n, 10)]

    train, val = split(40), split(20)
    want = je.knn_eval(lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])),
                       train, val, classes, k=200)
    got = pe.knn_eval(lambda b: (torch.from_numpy(b[0]),
                                 torch.from_numpy(b[1])),
                      train, val, classes, k=200)
    assert got == want and got > 0.8
