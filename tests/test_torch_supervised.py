"""The supervised stages of the port (sm3x_torch.train.supervised,
mlc_eval, backbone_eval, the freeze policies of train.common) against the
JAX package (sm3x.train.supervised with the apply functions of
sm3x/train/mlc_eval.py:85-96 and backbone_eval.py:74-87) on the same
weights, labels and pre-augmented views, on the CPU in float32.

Sizes: resnet18, 32x32, `mlc_proj_dim` 32, `sa_dim_ff` 16, batch 8, lr 1e-3.
Dropout is 0 (the frameworks draw different masks) and the views are fixed:
the JAX step gets an `aug_fn` that hands its input through, the port's
`supervised_update` takes views. Losses are held at rtol 1e-5 at each of
three steps where the encoders run in eval mode (fc, projector), and at the
first step under `all`; parameters at atol 3 x lr, the bound of AdamW's
update where a near-zero gradient flips sign; frozen tensors bit-identical
to what was loaded; the eval step from uint8 canvases at atol 1e-4.

Under `all` the encoders run train-mode batch norm over 8 images and take
gradients: at this size float32 weight gradients are ill-conditioned in both
frameworks (tests/test_torch_train_step.py measured single convs 3-8% off
their float64 values, ~5e-4 relative on the next loss), and
`sm3x.models.mlc.MLCModel` builds its head in float32 whatever its dtype, so
float64 is no way out here. The second and third losses under `all` are held
at rtol 5e-4 (measured: 7.4e-5 at the third step of the MLC model), and
the parameters at 2 x 3 x lr, the bound where a gradient's sign differs at
each of the three steps, with all but a 1e-4 share of each tensor within
3 x lr (measured: 1 entry of 73728 of one conv at 3.04 x lr).
"""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x import NUM_CLASSES
from sm3x.losses import weighted_multilabel_ce as jax_ce
from sm3x.models.baseline import Baseline as JaxBaseline
from sm3x.models.mlc import MLCModel as JaxMLCModel
from sm3x.ops.augment import FINETUNE_AUG as JAX_AUG
from sm3x.train import common as jax_common
from sm3x.train import supervised as js
from sm3x_torch.core.config import EvalConfig
from sm3x_torch.losses import cross_entropy, weighted_multilabel_ce
from sm3x_torch.models.baseline import Baseline
from sm3x_torch.models.mlc import MLCModel
from sm3x_torch.train import common, supervised
from sm3x_torch.train.backbone_eval import (BackboneEvalTrainer,
                                            baseline_encoder_state)
from sm3x_torch.train.mlc_eval import MLCEvalTrainer, _graft
from sm3x_torch.utils import weights

torch.set_num_threads(2)

LR, WD = 1e-3, 5e-2
B, SIZE, PROJ, FF, STEPS = 8, 32, 32, 16, 3
MEAN, STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
LABEL_WEIGHTS = (1.0, 0.5, 2.0, 1.0, 1.0, 1.0, 1.0, 0.25)
# (model, --finetune): the three MLC policies, backbone_eval's fc and other
CASES = [("mlc", "fc"), ("mlc", "projector"), ("mlc", "all"),
         ("baseline", "fc"), ("baseline", "all")]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _handed_through(key, canvases, hw, mean, std, cfg):
    return canvases


def _labels(rng, n=B):
    return np.stack([rng.integers(0, c, n) for c in NUM_CLASSES],
                    axis=1).astype(np.int32)


def test_weighted_multilabel_ce_matches_jax(rng_np):
    logits = [3 * rng_np.standard_normal((B, c)).astype(np.float32)
              for c in NUM_CLASSES]
    labels = _labels(rng_np)
    want = float(jax_ce([jnp.asarray(x) for x in logits], jnp.asarray(labels),
                        LABEL_WEIGHTS))
    got = weighted_multilabel_ce([torch.from_numpy(x) for x in logits],
                                 torch.from_numpy(labels), LABEL_WEIGHTS)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # bf16 logits are read in float32
    one = cross_entropy(torch.from_numpy(logits[0]).bfloat16(),
                        torch.from_numpy(labels[:, 0]))
    assert one.dtype == torch.float32


def _jax_model(kind):
    x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
    if kind == "mlc":
        jm = JaxMLCModel(arch="resnet18", proj_dim=PROJ, sa_dim_ff=FF,
                         sa_dropout=0.0, use_prototype_bias=True,
                         dtype=jnp.float32)
        v = jm.init({"params": jax.random.key(0),
                     "dropout": jax.random.key(1)}, x, x)
        to_sd = weights.mlc_state_dict
    else:
        jm = JaxBaseline(arch="resnet18", dtype=jnp.float32)
        v = jm.init(jax.random.key(0), x, x, train=False)
        to_sd = weights.baseline_state_dict
    return jm, _np_tree(v["params"]), _np_tree(v["batch_stats"]), to_sd


def _jax_policy(kind, finetune):
    fn = (jax_common.mlc_eval_trainable if kind == "mlc"
          else jax_common.backbone_eval_trainable)
    return lambda path: fn(path, finetune)


def _port_policy(kind, finetune):
    fn = (common.mlc_eval_trainable if kind == "mlc"
          else common.backbone_eval_trainable)
    return lambda name: fn(name, finetune)


def _port_model(kind, sd, finetune, eps=1e-8):
    model = (MLCModel("resnet18", proj_dim=PROJ, sa_dim_ff=FF, sa_dropout=0.0,
                      use_prototype_bias=True) if kind == "mlc"
             else Baseline("resnet18"))
    model.load_state_dict(weights.to_tensors(sd), strict=True)
    opt = common.make_adamw(common.trainable_parameters(
        model, _port_policy(kind, finetune)), LR, WD, eps=eps)
    return model, opt


def _forward_train(kind, model, finetune):
    if kind == "mlc":
        return lambda d, c, gen: model(
            d, c, extractor_train=finetune == "all",
            head_train=finetune in ("projector", "all"),
            stop_extractor_grad=finetune != "all", generator=gen)[1]
    return lambda d, c, gen: model(d, c, train=finetune != "fc",
                                   stop_backbone_grad=finetune == "fc",
                                   generator=gen)


def _jax_steps(kind, jm, finetune):
    if kind == "mlc":
        def apply_train(params, stats, d, c, kdrop):
            (_, preds), mut = jm.apply(
                {"params": params, "batch_stats": stats}, d, c,
                extractor_train=finetune == "all",
                head_train=finetune in ("projector", "all"),
                stop_extractor_grad=finetune != "all",
                mutable=["batch_stats"], rngs={"dropout": kdrop})
            return preds, mut["batch_stats"]

        def apply_eval(params, stats, d, c):
            return jm.apply({"params": params, "batch_stats": stats}, d, c)[1]
    else:
        def apply_train(params, stats, d, c, kdrop):
            preds, mut = jm.apply(
                {"params": params, "batch_stats": stats}, d, c,
                train=finetune != "fc", stop_backbone_grad=finetune == "fc",
                mutable=["batch_stats"])
            return preds, mut["batch_stats"]

        def apply_eval(params, stats, d, c):
            return jm.apply({"params": params, "batch_stats": stats}, d, c,
                            train=False)
    return js.make_supervised_steps(
        apply_train, apply_eval, LABEL_WEIGHTS, MEAN, STD, JAX_AUG,
        (SIZE, SIZE), aug_fn=_handed_through)


@pytest.fixture(scope="module")
def models():
    return {kind: _jax_model(kind) for kind in ("mlc", "baseline")}


@pytest.mark.parametrize("kind,finetune", CASES)
def test_trainable_set_equals_the_jax_policy(models, kind, finetune):
    """The JAX policy's mask, carried through the weight bridge's name map
    as arrays of ones and zeros, marks the same tensors as the port's
    policy over its parameter names."""
    _, params, stats, to_sd = models[kind]
    mask = jax_common.path_mask(params, _jax_policy(kind, finetune))
    marked = jax.tree.map(
        lambda p, m: np.full(np.shape(p), float(m), np.float32), params, mask)
    sd = to_sd(marked, stats)
    model, opt = _port_model(kind, to_sd(params, stats), finetune)
    want = {k for k, _ in model.named_parameters() if sd[k].all()}
    assert all(sd[k].all() or not sd[k].any()
               for k, _ in model.named_parameters())
    got = {k for k, p in model.named_parameters() if p.requires_grad}
    assert got == want and got
    assert sum(len(g["params"]) for g in opt.param_groups) == len(got)
    if (kind, finetune) == ("mlc", "all"):
        stem = [k for k, _ in model.named_parameters()
                if ".encoder.conv1." in k or ".encoder.bn1." in k]
        assert len(stem) == 6 and not set(stem) & got
        assert any(".encoder.layer1." in k for k in got)
    if (kind, finetune) == ("mlc", "fc"):
        assert all(k.startswith("prototypes.") for k in got)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown finetune policy"):
        common.mlc_eval_trainable("prototypes.0.weight", "head")
    with pytest.raises(ValueError, match="unknown finetune policy"):
        jax_common.mlc_eval_trainable("head/prototypes/proto0/kernel", "head")


@pytest.mark.parametrize("kind,finetune", CASES)
def test_three_steps_match_jax(models, kind, finetune):
    jm, params, stats, to_sd = models[kind]
    rng = np.random.default_rng(3407)
    views = rng.standard_normal((STEPS, 2, B, SIZE, SIZE, 3)).astype(
        np.float32)
    labels = np.stack([_labels(rng) for _ in range(STEPS)])
    eps = 1e-8 if kind == "mlc" else 1e-5

    mask = jax_common.path_mask(params, _jax_policy(kind, finetune))
    state = jax_common.create_train_state(
        jm, {"params": jax.tree.map(jnp.asarray, params),
             "batch_stats": jax.tree.map(jnp.asarray, stats)},
        jax_common.make_adamw(LR, WD, eps=eps, mask_tree=mask))
    train_step, _ = _jax_steps(kind, jm, finetune)
    hw = jnp.zeros((B, 2), jnp.int32)
    want_losses, want_preds = [], None
    for s in range(STEPS):
        state, loss, preds = train_step(
            state, jnp.asarray(views[s, 0]), hw, jnp.asarray(views[s, 1]), hw,
            jnp.asarray(labels[s]), jax.random.key(10 + s))
        want_losses.append(float(loss))
        if s == 0:  # before the two sides' weights drift apart
            want_preds = [np.asarray(p) for p in preds]
            first_stats = to_sd(params, _np_tree(state.batch_stats))
    final = to_sd(_np_tree(state.params), _np_tree(state.batch_stats))

    init = to_sd(params, stats)
    model, opt = _port_model(kind, init, finetune, eps)
    forward = _forward_train(kind, model, finetune)
    for s in range(STEPS):
        loss, preds = supervised.supervised_update(
            forward, opt, torch.from_numpy(views[s, 0]),
            torch.from_numpy(views[s, 1]),
            torch.from_numpy(labels[s]).long(), LABEL_WEIGHTS)
        rtol = 5e-4 if finetune == "all" and s > 0 else 1e-5
        np.testing.assert_allclose(float(loss), want_losses[s], rtol=rtol,
                                   err_msg=f"step {s}")
        assert not any(p.requires_grad for p in preds)
        if s == 0:
            for g, w in zip(preds, want_preds):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4)
            for k, v in model.state_dict().items():
                if "running" in k:  # the first step's statistics
                    np.testing.assert_allclose(v.numpy(), first_stats[k],
                                               rtol=1e-4, atol=1e-5, err_msg=k)
    have = model.state_dict()
    trainable = {k for k, p in model.named_parameters() if p.requires_grad}
    for k, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - final[k])
        if finetune == "all":
            assert diff.max() <= 2 * STEPS * LR, k
            assert (diff > 3 * LR).mean() <= 1e-4, k
        else:
            assert diff.max() <= 3 * LR, k
        if k in trainable:
            assert not np.array_equal(p.detach().numpy(), init[k]), k
        else:  # no update and no weight decay, on either side
            np.testing.assert_array_equal(p.detach().numpy(), init[k], k)
            np.testing.assert_array_equal(final[k], init[k], k)
    encoder_stats = [k for k in have if "running" in k and (
        "backbone" in k)]
    moved = [k for k in encoder_stats
             if not np.array_equal(have[k].numpy(), init[k])]
    if finetune == "all":
        # train mode: every statistic moves, the frozen stem's included
        assert moved == encoder_stats
        assert any(".bn1.running_mean" in k and "layer" not in k
                   for k in moved)
        assert all(not np.array_equal(final[k], init[k])
                   for k in encoder_stats)
    else:
        assert moved == []
        for k in encoder_stats:
            np.testing.assert_array_equal(final[k], init[k], k)


@pytest.mark.parametrize("kind", ["mlc", "baseline"])
def test_eval_step_from_uint8_canvases_matches_jax(models, rng_np, kind):
    jm, params, stats, to_sd = models[kind]
    canvas = 48
    derm, clinic = (rng_np.integers(0, 256, (B, canvas, canvas, 3),
                                    dtype=np.uint8) for _ in range(2))
    d_hw, c_hw = (rng_np.integers(canvas // 2, canvas + 1, (B, 2)).astype(
        np.int32) for _ in range(2))
    _, jax_eval = _jax_steps(kind, jm, "fc")
    want = jax_eval(jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, stats), jnp.asarray(derm),
                    jnp.asarray(d_hw), jnp.asarray(clinic), jnp.asarray(c_hw))
    model, opt = _port_model(kind, to_sd(params, stats), "fc")
    forward_eval = ((lambda d, c: model(d, c)[1]) if kind == "mlc"
                    else (lambda d, c: model(d, c, train=False)))
    _, eval_step = supervised.make_supervised_steps(
        None, forward_eval, opt, LABEL_WEIGHTS, MEAN, STD, None, (SIZE, SIZE))
    got = eval_step(*(torch.from_numpy(x) for x in (derm, d_hw, clinic, c_hw)))
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelname, record.getMessage()))


def _logger(name):
    logger = logging.getLogger(name)
    logger.handlers, logger.propagate = [], False
    logger.setLevel(logging.DEBUG)
    handler = _Records()
    logger.addHandler(handler)
    return logger, handler


def test_graft_warns_of_missing_keys_and_raises_on_a_shape(models):
    _, params, stats, to_sd = models["mlc"]
    sd = weights.to_tensors(to_sd(params, stats))
    stage2 = {k: v for k, v in sd.items()
              if not (k.startswith("prototypes.") and k.endswith(".bias"))}
    stage2["not.in.the.model"] = torch.zeros(1)
    model = MLCModel("resnet18", proj_dim=PROJ, sa_dim_ff=FF,
                     use_prototype_bias=True)
    logger, seen = _logger("graft_test")
    missing = _graft(model, stage2, logger)
    assert missing == [f"prototypes.{i}.bias" for i in range(8)]
    assert seen.lines == [("WARNING", f"Missing key in checkpoint: {k}")
                          for k in missing]
    have = model.state_dict()
    for k, v in stage2.items():
        if k in have:
            assert torch.equal(have[k], v), k
    wrong = dict(stage2)
    wrong["mlc_sa.linear1.weight"] = torch.zeros(2 * FF, PROJ)
    with pytest.raises(ValueError, match=(
            r"checkpoint shape mismatch at mlc_sa\.linear1\.weight: model "
            r"expects \(16, 32\) but the checkpoint holds \(32, 32\)")):
        _graft(model, wrong, logger)


def _eval_cfg(tmp_path, finetune, **kw):
    cfg = EvalConfig()
    m = cfg.model
    m.arch, m.mlc_proj_dim, m.sa_dim_ff, m.finetune = ("resnet18", PROJ, FF,
                                                       finetune)
    for k, v in kw.items():
        setattr(m, k, v)
    cfg.data.img_sz, cfg.train_sz, cfg.test_sz = (SIZE, SIZE), SIZE, SIZE
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = B, 1, False
    cfg.run.device, cfg.run.log_path = "cpu", str(tmp_path)
    return cfg


def test_mlc_eval_trainer_settings(tmp_path, models):
    """AdamW's eps is the 1e-8 default (not stage 1's 1e-5), the prototypes
    have a bias, --init-prototype re-draws them from the seed's stream 1,
    and a policy outside fc | projector | all raises."""
    _, params, stats, to_sd = models["mlc"]
    sd = weights.to_tensors(to_sd(params, stats))
    logger, _ = _logger("mlc_eval_settings")
    t = MLCEvalTrainer(_eval_cfg(tmp_path, "projector"), logger=logger,
                       pretrained_state=sd)
    assert t.optimizer.defaults["eps"] == 1e-8
    assert t.optimizer.defaults["lr"] == 1e-3 and t.missing_keys == []
    assert torch.equal(t.model.prototypes[0].weight.detach(),
                       sd["prototypes.0.weight"])
    fresh = [MLCEvalTrainer(_eval_cfg(tmp_path, "projector",
                                      init_prototype=True), logger=logger,
                            pretrained_state=sd) for _ in range(2)]
    w = [f.model.prototypes[0].weight.detach() for f in fresh]
    assert torch.equal(w[0], w[1])
    assert not torch.equal(w[0], sd["prototypes.0.weight"])
    assert float(fresh[0].model.prototypes[0].bias.abs().max()) == 0
    assert torch.equal(fresh[0].model.mlc_sa.linear1.weight.detach(),
                       sd["mlc_sa.linear1.weight"])
    with pytest.raises(ValueError, match="unknown finetune policy"):
        MLCEvalTrainer(_eval_cfg(tmp_path, "head"), logger=logger)
    bk = BackboneEvalTrainer(_eval_cfg(tmp_path, "fc"), logger=logger)
    assert bk.optimizer.defaults["eps"] == 1e-5


def test_baseline_takes_a_stage1_file_s_encoders():
    state = {"derm_backbone.encoder.conv1.weight": 1,
             "clinic_backbone.encoder.layer1.0.bn1.bias": 2,
             "derm_backbone.projector.0.weight": 3}
    assert baseline_encoder_state(state) == {
        "derm_backbone.conv1.weight": 1,
        "clinic_backbone.layer1.0.bn1.bias": 2}


def test_concat_masked_drops_the_padding_in_one_transfer():
    steps = [[torch.full((4, c), float(s)) for c in NUM_CLASSES]
             for s in range(3)]
    targets = [np.full((4, 8), s) for s in range(3)]
    masks = [np.ones(4, bool), np.ones(4, bool),
             np.array([True, True, False, False])]
    preds, tgt = supervised._concat_masked(steps, targets, masks)
    assert [p.shape for p in preds] == [(10, c) for c in NUM_CLASSES]
    assert tgt.shape == (10, 8) and tgt[-1, 0] == 2
    assert all(p[-1, 0] == 2.0 and p[0, 0] == 0.0 for p in preds)
