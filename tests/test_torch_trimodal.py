"""The tri-modal stage 1 (--arch-version trimodal) of the port against the
JAX package, on the CPU: `TriModalSimCLR` and `trimodal_ssl_loss` against
sm3x.models.trimodal on weights carried over by
`sm3x_torch.utils.weights.trimodal_state_dict` and views and metadata codes
made with numpy, with the port's dropout masks given to the Flax model
(jax.random's masks cannot be drawn in torch); one `trimodal_update` against
the JAX package's step in float64; `MetaEncoder`'s initialisers; the
dropout's keep share and 1 / (1 - p) scale; masks that do not depend on
the number of processes; the trainer's refusals and checkpoint.

resnet18 at 32x32, B = 4, two groups, vocabularies (4, 4, 16). The JAX side
runs once, under one jax.jit, in float64; the port in float64 is held at
rtol 1e-4 / atol 1e-5 (forwards) and rtol 1e-5 (losses), in float32 at rtol
1e-4 (the loss; tests/test_torch_multicrop.py says why), and after one step
as tests/test_torch_train_step.py holds its parameters.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from sm3x.models.trimodal import MetaEncoder as JaxMetaEncoder
from sm3x.models.trimodal import TriModalSimCLR as JaxTriModalSimCLR
from sm3x.models.trimodal import trimodal_ssl_loss as jax_trimodal_loss
from sm3x.train import common as jax_common
from sm3x_torch.core.mesh import Rows, batch_rows
from sm3x_torch.models.trimodal import (MetaEncoder, TriModalSimCLR,
                                        trimodal_ssl_loss)
from sm3x_torch.models.transformer import dropout
from sm3x_torch.train.backbone_train import trimodal_update
from sm3x_torch.train.common import make_adamw
from sm3x_torch.utils import weights

torch.set_num_threads(2)

LR, WD, EPS, T, GROUPS = 1e-4, 5e-2, 1e-5, 0.1, 2
B, SIZE, VOCAB, P = 4, 32, (4, 4, 16), 0.2
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
MASK_SEED = 11


def _inputs():
    rng = np.random.default_rng(3407)
    views = rng.standard_normal((4, B, SIZE, SIZE, 3)).astype(np.float32)
    codes = np.stack([rng.integers(0, v, B) for v in VOCAB],
                     axis=1).astype(np.int32)
    return views, codes


def _masks():
    """The two dropout masks the port's metadata views draw, in order, from
    a generator seeded MASK_SEED (transformer.dropout keeps u >= p)."""
    gen = torch.Generator().manual_seed(MASK_SEED)
    shape = (B, 64 * len(VOCAB))
    return [(torch.rand(shape, generator=gen) >= P).numpy()
            for _ in range(2)]


def _given_masks(masks):
    """A Flax interceptor that applies `masks` in order at the Dropout
    calls, as Flax's Dropout applies its own: x / keep where kept, else 0."""
    left = list(masks)

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            x = args[0]
            mask = jnp.asarray(left.pop(0))
            return jnp.where(mask, x / (1.0 - P), jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    return fnn.intercept_methods(intercept)


@pytest.fixture(scope="module")
def reference():
    views, codes = _inputs()
    with jax.enable_x64(True):
        jm = JaxTriModalSimCLR(arch="resnet18", proj_dim=16,
                               meta_vocab_sizes=VOCAB, dtype=jnp.float64)
        x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float64)
        v = jm.init({"params": jax.random.key(0),
                     "dropout": jax.random.key(1)}, (x, x), (x, x),
                    jnp.zeros((2, len(VOCAB)), jnp.int32), train=False)
        state = jax_common.create_train_state(
            jm, v, jax_common.make_adamw(LR, WD, eps=EPS))

        @jax.jit
        def step(state, views, codes):
            def loss_fn(params):
                with _given_masks(_masks()):
                    outs, mut = jm.apply(
                        {"params": params, "batch_stats": state.batch_stats},
                        (views[0], views[1]), (views[2], views[3]), codes,
                        train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.key(2)})
                total, parts = jax_trimodal_loss(outs, T, GROUPS)
                return total, (mut["batch_stats"], parts, outs)

            (loss, (stats, parts, outs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params)
            return (state.apply_gradients(grads=grads, batch_stats=stats),
                    loss, parts, outs)

        new, loss, parts, outs = step(state, jnp.asarray(views, jnp.float64),
                                      jnp.asarray(codes))
        outs = jax.tree.map(np.asarray, outs)
        after = weights.trimodal_state_dict(
            jax.tree.map(np.asarray, new.params),
            jax.tree.map(np.asarray, new.batch_stats))
    init = weights.trimodal_state_dict(v["params"], v["batch_stats"])
    return (init, (views, codes), outs, float(loss),
            {k: float(p) for k, p in parts.items()}, after)


def _port(init, dtype):
    model = TriModalSimCLR("resnet18", 16, VOCAB)
    model.load_state_dict(weights.to_tensors(init), strict=True)
    return model.to(dtype).train()


def _args(inputs, dtype):
    views, codes = inputs
    v = torch.from_numpy(views).to(dtype)
    return ((v[0], v[1]), (v[2], v[3]), torch.from_numpy(codes).long(),
            torch.Generator().manual_seed(MASK_SEED))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().double().numpy(), want, **tol)


def test_forward_and_loss_match_jax(reference):
    init, inputs, outs, loss, parts, _ = reference
    model = _port(init, torch.float64)
    got = model(*_args(inputs, torch.float64))
    assert sorted(got) == sorted(outs)
    for key in ("derm_z", "clinic_z"):
        _close(got[key], outs[key], **FWD_TOL)
    for key in ("cross_derm_z", "cross_clinic_z", "cross_meta_z"):
        for g, w in zip(got[key], outs[key]):
            _close(g, w, **FWD_TOL)
    total, got_parts = trimodal_ssl_loss(got, T, GROUPS)
    assert sorted(got_parts) == sorted(parts)
    np.testing.assert_allclose(float(total), loss, rtol=1e-5)
    for k, v in parts.items():
        np.testing.assert_allclose(float(got_parts[k]), v, rtol=1e-5,
                                   err_msg=k)


def test_loss_in_float32(reference):
    init, inputs, _, loss, _, _ = reference
    model = _port(init, torch.float32)
    total, _ = trimodal_ssl_loss(model(*_args(inputs, torch.float32)), T,
                                 GROUPS)
    np.testing.assert_allclose(float(total), loss, rtol=1e-4)


def test_step_matches_jax_in_float64(reference):
    init, inputs, _, loss, _, after = reference
    model = _port(init, torch.float64)
    opt = make_adamw(model.parameters(), LR, WD, eps=EPS)
    d, c, codes, gen = _args(inputs, torch.float64)
    got = trimodal_update(model, opt, d, c, codes, gen, T, GROUPS)
    assert sorted(got) == ["clinic", "cross", "derm", "loss", "meta"]
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    far = total = 0
    for k, p in model.named_parameters():
        p = p.detach().numpy()
        np.testing.assert_allclose(p, after[k], atol=3 * LR, err_msg=k)
        far += int((np.abs(p - after[k]) > 1e-2 * LR).sum())
        total += p.size
    assert far <= 1e-4 * total, f"{far} of {total} entries beyond 1e-2 x lr"


@pytest.mark.parametrize("kind", ["dual", "tri"])
def test_updates_clear_the_gradients_before_the_forward(kind):
    """`ssl_update` and `trimodal_update` drop the last step's gradients
    before the forward, so they are not held through it: every parameter's
    `.grad` is None when the second step's forward starts."""
    from sm3x_torch.models.simclr import build_ssl_model
    from sm3x_torch.train.backbone_train import ssl_update

    torch.manual_seed(0)
    model = (build_ssl_model("v32", "resnet18", 16)[0] if kind == "dual"
             else TriModalSimCLR("resnet18", 16, VOCAB))
    opt = make_adamw(model.parameters(), LR, WD, eps=EPS)
    held = []
    model.register_forward_pre_hook(lambda m, a: held.append(sum(
        p.grad is not None for p in m.parameters())))
    rng = np.random.default_rng(0)
    for _ in range(2):
        v = torch.from_numpy(rng.standard_normal((4, B, 16, 16, 3)).astype(
            np.float32))
        if kind == "dual":
            ssl_update(model, opt, (v[0], v[1]), (v[2], v[3]), 0, T, GROUPS)
        else:
            codes = torch.from_numpy(_inputs()[1]).long()
            trimodal_update(model, opt, (v[0], v[1]), (v[2], v[3]), codes,
                            torch.Generator().manual_seed(1), T, GROUPS)
    assert held == [0, 0]
    assert all(p.grad is not None for p in model.parameters())


def test_meta_encoder_initialisers_match_flax():
    """Embedding tables N(0, 1 / embed_dim) as Flax's nn.Embed draws them
    (not torch's N(0, 1)), linear weights within +-1 / sqrt(fan_in), biases
    zero; the same statistics on both sides over a wide table."""
    vocab = (4000, 3)
    jm = JaxMetaEncoder(vocab)
    p = jm.init(jax.random.key(0), jnp.zeros((2, 2), jnp.int32))["params"]
    torch.manual_seed(0)
    tm = MetaEncoder(vocab)
    want = np.asarray(p["embed0"]["embedding"])
    got = tm.embeds[0].weight.detach().numpy()
    assert got.shape == want.shape == (4000, 64)
    np.testing.assert_allclose([got.mean(), got.std()],
                               [want.mean(), want.std()], atol=2e-3)
    np.testing.assert_allclose(got.std(), 1 / 8, rtol=1e-2)
    for name, fan_in in (("fc1", 128), ("fc2", 256)):
        lin = getattr(tm, name)
        bound = 1 / np.sqrt(fan_in)
        for w in (lin.weight.detach().numpy(),
                  np.asarray(p[name]["kernel"])):
            assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
        assert not lin.bias.detach().any()
        assert not np.asarray(p[name]["bias"]).any()
    assert set(tm.state_dict()) == {
        "embeds.0.weight", "embeds.1.weight", "fc1.weight", "fc1.bias",
        "fc2.weight", "fc2.bias"}


def test_dropout_keeps_one_minus_p_and_scales_by_its_inverse():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(400, 500)
    y = dropout(x, P, True, gen)
    kept = y != 0
    np.testing.assert_allclose(float(kept.float().mean()), 1 - P, atol=5e-3)
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - P)))
    assert torch.equal(dropout(x, P, False, gen), x)


def test_metadata_views_do_not_depend_on_the_processes():
    """Inside batch_rows(rows) every rank draws the masks of the whole batch
    and keeps its rows: two ranks' views are the one-process views' rows;
    the two views differ."""
    torch.manual_seed(0)
    enc = MetaEncoder(VOCAB).train()
    codes = torch.from_numpy(np.random.default_rng(0).integers(
        0, 4, (8, 3))).long()

    def views(rows, part):
        gen = torch.Generator().manual_seed(5)
        with batch_rows(rows):
            return [enc(part, gen) for _ in range(2)]

    whole = views(None, codes)
    assert not torch.equal(whole[0], whole[1])
    for r in range(2):
        rows = Rows(4 * r, 4 * r + 4, 8)
        for got, want in zip(views(rows, codes[4 * r:4 * r + 4]), whole):
            assert torch.equal(got, want[4 * r:4 * r + 4])


def _cfg(tmp_path, **data):
    from sm3x_torch.core.config import SSLConfig

    cfg = SSLConfig()
    cfg.model.arch, cfg.model.proj_dim = "resnet18", 16
    cfg.model.arch_version, cfg.model.meta_vocab_sizes = "trimodal", VOCAB
    cfg.data.img_sz = (SIZE, SIZE)
    for k, v in data.items():
        setattr(cfg.data, k, v)
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = 8, 1, False
    cfg.run.device, cfg.run.log_path, cfg.run.world_size = ("cpu",
                                                            str(tmp_path), 2)
    cfg.run.save_freq = 1
    return cfg


def test_trainer_refuses_multicrop_and_a_batch_without_codes(tmp_path):
    import dataclasses

    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.train.backbone_train import SSLTrainer

    with pytest.raises(ValueError, match="are not combinable"):
        SSLTrainer(_cfg(tmp_path, data_name="SevenPCSwavDataset"))
    trainer = SSLTrainer(_cfg(tmp_path))
    batch = next(iter(SyntheticPairedData(8, canvas=40).batches(8)))
    with pytest.raises(ValueError, match="needs a dataset with metadata"):
        trainer._meta(dataclasses.replace(batch, meta=None))


def test_trainer_fits_and_its_checkpoint_feeds_the_later_stages(tmp_path):
    """One epoch through fit on synthetic canvases and codes: finite
    losses, a ckp_0.pth that loads strictly into a new TriModalSimCLR, and
    whose `{derm,clinic}_backbone.encoder.*` stage 2 reads."""
    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.train.backbone_train import SSLTrainer
    from sm3x_torch.utils.checkpoint import load_encoder_state

    trainer = SSLTrainer(_cfg(tmp_path))
    hist = trainer.fit(SyntheticPairedData(16, canvas=40, seed=0))
    assert len(hist[0]["step_losses"]) == 2
    assert all(np.isfinite(hist[0]["step_losses"]))
    path = str(tmp_path / "ckp_0.pth")
    ckpt = torch.load(path, weights_only=True)
    TriModalSimCLR("resnet18", 16, VOCAB).load_state_dict(
        ckpt["state_dict"], strict=True)
    enc = load_encoder_state(path)
    assert enc and all(k.startswith(("derm_backbone.encoder.",
                                     "clinic_backbone.encoder."))
                       for k in enc)
