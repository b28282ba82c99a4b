"""Stage-1 steps of the port (sm3x_torch.train.backbone_train.ssl_update)
against a JAX reference composed from the JAX package (model.apply with
mutable batch stats + sm3x.losses.ssl.ssl_loss + sm3x.train.common.make_adamw),
on fixed pre-augmented views, on the CPU.

The reference computes in float64 (scoped `jax.enable_x64`; its parameters
stay float32). At these test sizes (random init, 8 images, train-mode BN)
float32 weight gradients are ill-conditioned in both frameworks: measured
against float64, the port's float32 gradient of one conv was 3.2% off and
the JAX package's float32 gradient of another 8% off. After one AdamW step
such errors move the next loss by ~5e-4 relative. So the three-step check
runs the port in float64 too, where it must agree with the reference in
loss (rtol 1e-5) at every step: the reference keeps its parameters and
AdamW moments in float32, which alone moves its third loss by 2.6e-6
relative. Parameters are held at atol 3 x lr, the bound of AdamW's update
(lr times about a sign) where a near-zero gradient flips sign, and in
float64 all but a 1e-4 share of them at atol 1e-2 x lr: AdamW's eps (1e-5)
is the size of the smallest gradients here, so the float32 moments of the
reference move single entries by a few percent of lr (one entry of 36864
in a conv by 4.7e-2 x lr after three steps). The float32 port is held to
the first step's loss at rtol 1e-4.

The --bn-stat-freq fast step (the model in eval mode: running statistics
used and kept, the gradient step whole) is held against the JAX package's
`model.apply(..., train=False)` step from the same initial state on the
first views, then a standard step on the second views, in float64: the
losses at rtol 1e-5, the parameters at the three-step check's bounds, the
running statistics unchanged bit for bit by the fast step and at rtol
1e-5 / atol 1e-7 of the reference's (kept in float32) after the standard
one.

The three-step check runs again with the AdamW of a step replayed as a
CUDA graph (`make_adamw(..., fused=True)`: torch's fused update, here its
CPU kernel), at the same bounds.

The same three-step check runs on a ViT v32 model with --use-checkpoint
flash, cut to dim 128, depth 2, 2 heads (head dim 64) at 32x32: on the CPU
the port's flash attention is its plain forward and analytic backward, and
the JAX package's is its checkpointed XLA attention.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.losses.ssl import ssl_loss as jax_ssl_loss
from sm3x.models.simclr import build_ssl_model as jax_build_ssl_model
from sm3x.train import common as jax_common
from sm3x_torch.models.simclr import build_ssl_model
from sm3x_torch.train.backbone_train import ssl_update
from sm3x_torch.train.common import make_adamw
from sm3x_torch.utils import weights

torch.set_num_threads(2)

STATS = ("running_mean", "running_var")

LR, WD, EPS, T, GROUPS = 1e-4, 5e-2, 1e-5, 0.1, 2
B, SIZE, STEPS = 8, 32, 3


VIT_CUT = dict(patch=16, dim=128, depth=2, n_heads=2)


def _reference(arch, remat=False, fast=False):
    """Views, initial state dict, per-step losses and per-step parameter
    state dicts of the JAX reference; with `fast`, also the losses and
    state dicts of a fast step (train=False) on the first views and a
    standard step on the second, from the initial state (else None)."""
    views = np.random.default_rng(3407).standard_normal(
        (STEPS, 4, B, SIZE, SIZE, 3)).astype(np.float32)
    with jax.enable_x64(True):
        jm, style = jax_build_ssl_model("v32", arch, 16, dtype=jnp.float64,
                                        remat=remat)
        x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float64)
        v = jm.init(jax.random.key(0), (x, x), (x, x), train=False)
        state = jax_common.create_train_state(
            jm, v, jax_common.make_adamw(LR, WD, eps=EPS))

        @partial(jax.jit, static_argnums=2)
        def step(state, vs, train):
            def loss_fn(params):
                variables = {"params": params,
                             "batch_stats": state.batch_stats}
                if train:
                    outs, mut = jm.apply(
                        variables, (vs[0], vs[1]), (vs[2], vs[3]),
                        train=True, mutable=["batch_stats"])
                    stats = mut["batch_stats"]
                else:   # sm3x/train/backbone_train.py's frozen_bn
                    outs = jm.apply(variables, (vs[0], vs[1]),
                                    (vs[2], vs[3]), train=False)
                    stats = state.batch_stats
                total, _ = jax_ssl_loss(outs, style, T, GROUPS)
                return total, stats

            (loss, stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params)
            return state.apply_gradients(grads=grads,
                                         batch_stats=stats), loss

        def run(state, trains):
            losses, sds = [], []
            for s, train in enumerate(trains):
                state, loss = step(state, jnp.asarray(views[s], jnp.float64),
                                   train)
                losses.append(float(loss))
                sds.append(weights.simclr_skin_state_dict(
                    jax.tree.map(np.asarray, state.params),
                    jax.tree.map(np.asarray, state.batch_stats)))
            return losses, sds

        initial = state
        losses, sds = run(state, [True] * STEPS)
        fast_run = run(initial, [False, True]) if fast else None
    init = weights.simclr_skin_state_dict(v["params"], v["batch_stats"])
    return style, views, init, losses, sds, fast_run


@pytest.fixture(scope="module")
def reference():
    return _reference("resnet18", fast=True)


@pytest.fixture(scope="module")
def vit_reference():
    """`vit_cut` registered in both packages' ViT tables while the module's
    tests run."""
    from sm3x.models import vit as jax_vit
    from sm3x_torch.models import vit

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_vit, vit):
            mp.setitem(mod.VIT_SPECS, "vit_cut", VIT_CUT)
            mp.setitem(mod.VIT_FEAT_DIMS, "vit_cut", VIT_CUT["dim"])
        yield _reference("vit_cut", remat="flash")


def _port(style, init, dtype, arch="resnet18", remat=False, fused=False):
    model, t_style = build_ssl_model("v32", arch, 16, remat=remat,
                                     img_size=SIZE)
    assert t_style == style
    model.load_state_dict(weights.to_tensors(init), strict=True)
    model.to(dtype).train()
    return model, make_adamw(model.parameters(), LR, WD, eps=EPS,
                             fused=fused)


def _step(model, opt, style, views, dtype, frozen_bn=False):
    tv = [torch.from_numpy(a).to(dtype) for a in views]
    return float(ssl_update(model, opt, (tv[0], tv[1]), (tv[2], tv[3]),
                            style, T, GROUPS, frozen_bn=frozen_bn)["loss"])


def _check_params(model, want_sd, atol, tight_atol=None, loose=()):
    """Every entry within `atol`; with `tight_atol`, all but a 1e-4 share
    of the entries within it too, leaving out the parameters whose names
    end with one of `loose`."""
    far = total = 0
    for k, p in model.named_parameters():
        got = p.detach().double().numpy()
        np.testing.assert_allclose(got, want_sd[k], atol=atol, err_msg=k)
        if tight_atol is not None and not k.endswith(loose):
            far += int((np.abs(got - want_sd[k]) > tight_atol).sum())
            total += got.size
    assert far <= 1e-4 * total, f"{far} of {total} entries beyond {tight_atol}"


def _three_steps(reference, loose=(), **port_kw):
    style, views, init, losses, sds, _ = reference
    model, opt = _port(style, init, torch.float64, **port_kw)
    for s in range(STEPS):
        got = _step(model, opt, style, views[s], torch.float64)
        np.testing.assert_allclose(got, losses[s], rtol=1e-5,
                                   err_msg=f"step {s}")
    _check_params(model, sds[-1], atol=3 * LR, tight_atol=1e-2 * LR,
                  loose=loose)


def test_three_steps_match_jax(reference):
    _three_steps(reference)


def test_three_steps_match_jax_with_the_graphed_trainers_adamw(reference):
    """The fused AdamW that `SSLTrainer` builds where its step is a CUDA
    graph."""
    _three_steps(reference, fused=True)


def test_three_steps_match_jax_vit(vit_reference):
    from sm3x_torch.ops import attention_cuda

    before = attention_cuda.flash_forward_cuda.launches
    # the projector's first BN removes any shift shared by the batch, so
    # ln_final.bias has a zero gradient in exact arithmetic; AdamW scales
    # what rounding leaves by lr / eps, and the reference's float32 moments
    # move half its entries by up to 5e-2 x lr: held at 3 x lr only
    _three_steps(vit_reference, loose=("ln_final.bias",), arch="vit_cut",
                 remat="flash")
    assert attention_cuda.flash_forward_cuda.launches == before


def test_fast_step_then_a_standard_step_match_jax(reference):
    """--bn-stat-freq's fast step, then the refresh step after it."""
    style, views, init, _, _, (losses, sds) = reference
    model, opt = _port(style, init, torch.float64)
    before = {k: b.clone() for k, b in model.named_buffers()}
    got = _step(model, opt, style, views[0], torch.float64, frozen_bn=True)
    np.testing.assert_allclose(got, losses[0], rtol=1e-5)
    assert all(m.training for m in model.modules())
    for k, b in model.named_buffers():
        assert torch.equal(b, before[k]), k
    _check_params(model, sds[0], atol=3 * LR, tight_atol=1e-2 * LR)
    got = _step(model, opt, style, views[1], torch.float64)
    np.testing.assert_allclose(got, losses[1], rtol=1e-5)
    _check_params(model, sds[1], atol=3 * LR, tight_atol=1e-2 * LR)
    for k, b in model.named_buffers():
        if k.endswith(STATS):
            assert not torch.equal(b, before[k]), k
            np.testing.assert_allclose(b.numpy(), sds[1][k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_first_step_in_float32(reference):
    style, views, init, losses, sds, _ = reference
    model, opt = _port(style, init, torch.float32)
    got = _step(model, opt, style, views[0], torch.float32)
    np.testing.assert_allclose(got, losses[0], rtol=1e-4)
    _check_params(model, sds[0], atol=3 * LR)


def test_synthetic_source_matches_jax_package():
    from sm3x.data.synthetic import synthetic_canvas_batch as jax_synth
    from sm3x_torch.data.synthetic import (SyntheticPairedData,
                                           synthetic_canvas_batch)

    for got, want in zip(synthetic_canvas_batch(5, 40, 7), jax_synth(5, 40, 7)):
        np.testing.assert_array_equal(got, want)
    data = SyntheticPairedData(10, canvas=40, seed=7)
    np.testing.assert_array_equal(data.clinic, jax_synth(10, 40, 8)[0])
    batches = list(data.batches(4, epoch=1))
    # the last batch is padded by wrapping, as the datasets pad theirs
    assert data.steps_per_epoch(4) == len(batches) == 3
    assert batches[0].derm.shape == (4, 40, 40, 3)
    assert [int(b.mask.sum()) for b in batches] == [4, 4, 2]


def test_trainer_fit_on_synthetic_canvases(tmp_path):
    """SSLTrainer.fit, the entry point of the card's smoke run, on the CPU:
    finite per-step losses, rank-0 ckp_0.pth, and no kernel launched."""
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.ops import augment_cuda, ntxent_cuda
    from sm3x_torch.train.backbone_train import SSLTrainer

    cfg = SSLConfig()
    cfg.model.arch, cfg.model.proj_dim = "resnet18", 16
    cfg.data.img_sz = (32, 32)
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = 8, 1, False
    cfg.run.device, cfg.run.world_size = "cpu", 2
    cfg.run.log_path, cfg.run.ckpt_freq = str(tmp_path), 100
    counters = (augment_cuda.photometric_cuda, ntxent_cuda.ntxent_forward_cuda,
                ntxent_cuda.ntxent_backward_cuda)
    before = [fn.launches for fn in counters]
    hist = SSLTrainer(cfg).fit(SyntheticPairedData(16, canvas=48, seed=0))
    losses = hist[0]["step_losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert [fn.launches for fn in counters] == before
    assert (tmp_path / "ckp_0.pth").exists()


def test_nan_guard_dumps_state_and_stops(tmp_path):
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.train.backbone_train import SSLTrainer

    cfg = SSLConfig()
    cfg.model.arch, cfg.model.proj_dim = "resnet18", 16
    cfg.run.device, cfg.run.log_path = "cpu", str(tmp_path)
    trainer = SSLTrainer(cfg)
    trainer.guard_loss(0, float("nan"))  # off by default: no effect
    cfg.run.nan_guard = True
    trainer.guard_loss(0, 1.0)
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.guard_loss(3, float("nan"))
    dump = torch.load(tmp_path / "nan_dump.pth", weights_only=True)
    assert dump["epoch"] == 4
