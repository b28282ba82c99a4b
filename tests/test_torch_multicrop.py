"""Multi-crop stage 1 (--data-name SevenPCSwavDataset) of the port against
the JAX package, on the CPU: `SimCLRSkinV3.multicrop` and `ssl_loss` with
its `local` term (local_weight 0.5) against `model.apply(...,
method="multicrop")` and `sm3x.losses.ssl.ssl_loss`, on weights carried
over by `sm3x_torch.utils.weights` and views made with numpy; one
`ssl_update` with the locals against the JAX package's step in float64;
the views of `multicrop_augment_batch`; the step's checks of the crop
lists with the JAX package's messages.

resnet18 at 32x32 globals and 16x16 locals, two locals a modality, B = 4,
two groups. The JAX side runs once, under one jax.jit, in float64 (scoped
`jax.enable_x64`; see tests/test_torch_train_step.py:6-21 for why a step
is compared in float64). Tolerances: forwards rtol 1e-4 / atol 1e-5 and
loss values rtol 1e-5, the port in float64 as the reference; the port in
float32 holds the loss at rtol 1e-4, as tests/test_torch_train_step.py
holds its first float32 step: at B = 4 the last stages' batch norms
normalise over 4 values a channel, where float32 rounding alone moves the
projections by up to 2e-4 (measured: the float32 port against the float64
reference). The float64 step's loss at rtol 1e-5 and its parameters as
tests/test_torch_train_step.py holds them. The JAX multi-crop *trainer* is
not run here (tests/isolated/test_multicrop.py: 80-1130 s on the CPU).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.losses.ssl import ssl_loss as jax_ssl_loss
from sm3x.models.simclr import SimCLRSkinV3 as JaxSimCLRSkinV3
from sm3x.train import common as jax_common
from sm3x_torch.core import prng
from sm3x_torch.models.simclr import build_ssl_model
from sm3x_torch.losses.ssl import ssl_loss
from sm3x_torch.ops import augment as A
from sm3x_torch.train.backbone_train import (make_ssl_train_step,
                                             multicrop_settings, ssl_update)
from sm3x_torch.train.common import make_adamw
from sm3x_torch.utils import weights

torch.set_num_threads(2)

LR, WD, EPS, T, GROUPS, LOCAL_WEIGHT = 1e-4, 5e-2, 1e-5, 0.1, 2, 0.5
B, SIZE, LOCAL, N_LOCAL = 4, 32, 16, 2
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
MEAN, STD = (0.7833, 0.6712, 0.6026), (0.2139, 0.2472, 0.2571)


def _views():
    rng = np.random.default_rng(3407)
    glob = rng.standard_normal((4, B, SIZE, SIZE, 3)).astype(np.float32)
    loc = rng.standard_normal((2 * N_LOCAL, B, LOCAL, LOCAL, 3)).astype(
        np.float32)
    return glob, loc


@pytest.fixture(scope="module")
def reference():
    """Initial weights, then the JAX package's multi-crop forward, loss and
    one AdamW step in float64: (init state dict, views, outputs, loss,
    parts, state dict after the step)."""
    glob, loc = _views()
    with jax.enable_x64(True):
        jm = JaxSimCLRSkinV3(arch="resnet18", proj_dim=16, dtype=jnp.float64,
                             shared_cross_proj=False)
        x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float64)
        v = jm.init(jax.random.key(0), (x, x), (x, x), train=False)
        state = jax_common.create_train_state(
            jm, v, jax_common.make_adamw(LR, WD, eps=EPS))

        @jax.jit
        def step(state, glob, loc):
            def loss_fn(params):
                outs, mut = jm.apply(
                    {"params": params, "batch_stats": state.batch_stats},
                    (glob[0], glob[1]), (glob[2], glob[3]),
                    tuple(loc[:N_LOCAL]), tuple(loc[N_LOCAL:]), train=True,
                    mutable=["batch_stats"], method="multicrop")
                total, parts = jax_ssl_loss(outs, 0, T, GROUPS,
                                            local_weight=LOCAL_WEIGHT)
                return total, (mut["batch_stats"], parts, outs)

            (loss, (stats, parts, outs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params)
            return (state.apply_gradients(grads=grads, batch_stats=stats),
                    loss, parts, outs)

        new, loss, parts, outs = step(state, jnp.asarray(glob, jnp.float64),
                                      jnp.asarray(loc, jnp.float64))
        outs = jax.tree.map(np.asarray, outs)
        after = weights.simclr_skin_state_dict(
            jax.tree.map(np.asarray, new.params),
            jax.tree.map(np.asarray, new.batch_stats))
    init = weights.simclr_skin_state_dict(v["params"], v["batch_stats"])
    return (init, (glob, loc), outs, float(loss),
            {k: float(p) for k, p in parts.items()}, after)


def _port(init, dtype):
    model, style = build_ssl_model("v32", "resnet18", 16)
    assert style == 0
    model.load_state_dict(weights.to_tensors(init), strict=True)
    return model.to(dtype).train()


def _inputs(views, dtype):
    glob, loc = (torch.from_numpy(a).to(dtype) for a in views)
    return ((glob[0], glob[1]), (glob[2], glob[3]), tuple(loc[:N_LOCAL]),
            tuple(loc[N_LOCAL:]))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().double().numpy(), want, **tol)


def test_multicrop_forward_and_loss_match_jax(reference):
    init, views, outs, loss, parts, _ = reference
    model = _port(init, torch.float64)
    got = model.multicrop(*_inputs(views, torch.float64))
    assert sorted(got) == sorted(outs)
    for key in ("derm_z", "clinic_z"):
        _close(got[key], outs[key], **FWD_TOL)
    for key in ("cross_derm_z", "cross_clinic_z", "derm_local_z",
                "clinic_local_z"):
        assert len(got[key]) == len(outs[key])
        assert got[key][0].shape == (B, 16)
        for g, w in zip(got[key], outs[key]):
            _close(g, w, **FWD_TOL)
    total, got_parts = ssl_loss(got, 0, T, GROUPS,
                                local_weight=LOCAL_WEIGHT)
    assert sorted(got_parts) == sorted(parts) == ["clinic", "cross", "derm",
                                                  "local"]
    np.testing.assert_allclose(float(total), loss, rtol=1e-5)
    for k, v in parts.items():
        np.testing.assert_allclose(float(got_parts[k]), v, rtol=1e-5,
                                   err_msg=k)


def test_multicrop_loss_in_float32(reference):
    init, views, _, loss, _, _ = reference
    model = _port(init, torch.float32)
    total, _ = ssl_loss(model.multicrop(*_inputs(views, torch.float32)), 0,
                        T, GROUPS, local_weight=LOCAL_WEIGHT)
    np.testing.assert_allclose(float(total), loss, rtol=1e-4)


def test_multicrop_step_matches_jax_in_float64(reference):
    """One `ssl_update` with the locals: the loss at rtol 1e-5 and every
    parameter within 3 x lr, all but a 1e-4 share within 1e-2 x lr; the
    running statistics, which the local views' own batches move too,
    within 1e-6."""
    init, views, _, loss, _, after = reference
    model = _port(init, torch.float64)
    opt = make_adamw(model.parameters(), LR, WD, eps=EPS)
    d, c, dl, cl = _inputs(views, torch.float64)
    got = ssl_update(model, opt, d, c, 0, T, GROUPS, derm_locals=dl,
                     clinic_locals=cl, local_weight=LOCAL_WEIGHT)
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    far = total = 0
    for k, p in model.named_parameters():
        p = p.detach().numpy()
        np.testing.assert_allclose(p, after[k], atol=3 * LR, err_msg=k)
        far += int((np.abs(p - after[k]) > 1e-2 * LR).sum())
        total += p.size
    assert far <= 1e-4 * total, f"{far} of {total} entries beyond 1e-2 x lr"
    for k, buf in model.named_buffers():
        if "running" in k:
            np.testing.assert_allclose(buf.numpy(), after[k], atol=1e-6,
                                       err_msg=k)


def _canvases(n=B, canvas=40):
    from sm3x_torch.data.synthetic import synthetic_canvas_batch

    canv, hw, _ = synthetic_canvas_batch(n, canvas, seed=5)
    return torch.from_numpy(canv), torch.from_numpy(hw)


CROPS = dict(size_crops=(SIZE, LOCAL, 8), nmb_crops=(2, 3, 2),
             min_scale_crops=(0.5, 0.14, 0.05), max_scale_crops=(1.0, 0.5,
                                                                 0.14))


def test_views_count_sizes_and_streams():
    """Every group's count at its size, globals first (the count and sizes
    as tests/test_augment_props.py:105 holds the JAX package's); view idx
    is `ssl_augment_batch` from the generator fold_in(seed, idx) under its
    group's size and scales, bit for bit, though a group's views share one
    photometric call."""
    from sm3x_torch.ops import augment_cuda

    canv, hw = _canvases()
    calls = []
    real = augment_cuda.photometric
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(augment_cuda, "photometric",
                   lambda x, *a: calls.append(x.shape[0]) or real(x, *a))
        views = A.multicrop_augment_batch(11, canv, hw, MEAN, STD, **CROPS)
    assert [tuple(v.shape) for v in views] == (
        [(B, SIZE, SIZE, 3)] * 2 + [(B, LOCAL, LOCAL, 3)] * 3
        + [(B, 8, 8, 3)] * 2)
    assert calls == [2 * B, 3 * B, 2 * B]
    idx = 0
    for size, n, lo, hi in zip(*CROPS.values()):
        cfg = dataclasses.replace(A.SSL_AUG, out_size=(size, size),
                                  rrc_scale=(lo, hi))
        for _ in range(n):
            want = A.ssl_augment_batch(prng.generator(prng.fold_in(11, idx),
                                                      "cpu"),
                                       canv, hw, MEAN, STD, cfg)
            assert torch.equal(views[idx], want), idx
            idx += 1


@pytest.mark.parametrize("group", [0, 1, 2])
def test_views_crop_within_their_group_s_scales(group):
    """The box a view crops covers a share of the valid area within its
    group's (min, max) scale, whenever one of the ten draws fits (else the
    centre fallback); the boxes come from the view's first draws."""
    canv, hw = _canvases(64, 96)
    size, lo, hi = (CROPS[k][group] for k in ("size_crops",
                                                 "min_scale_crops",
                                                 "max_scale_crops"))
    cfg = dataclasses.replace(A.SSL_AUG, out_size=(size, size),
                              rrc_scale=(lo, hi))
    h, w = hw[:, 0].float(), hw[:, 1].float()
    first = sum(CROPS["nmb_crops"][:group])
    y0, x0, ch, cw = A.sample_rrc_boxes(
        prng.generator(prng.fold_in(11, first), "cpu"), h, w, cfg)
    share = (ch * cw / (h * w)).numpy()
    # rounding each side to a pixel moves the share by under 2 / side
    slack = (2.0 / torch.minimum(ch, cw)).numpy()
    assert np.all(share >= lo - slack) and np.all(share <= hi + slack)
    assert bool(((y0 >= 0) & (y0 + ch <= h)).all())
    assert bool(((x0 >= 0) & (x0 + cw <= w)).all())


def test_crop_resize_at_fixed_boxes_matches_jax():
    """The local views' geometry: the same boxes resized to 16 x 16 by the
    port and by the JAX package's `_crop_resize_one` (rtol 1e-4, atol
    1e-5); the boxes are fixed, as jax.random's draws are not
    reproducible in torch."""
    from sm3x.ops.augment import _crop_resize_one

    canv, _ = _canvases(3, 40)
    img = canv.float() / 255.0
    boxes = np.array([[0, 0, 40, 40], [5, 7, 13, 21], [20, 3, 19, 9]],
                     np.float32)
    y0, x0, ch, cw = (torch.from_numpy(boxes[:, i]) for i in range(4))
    got = A.crop_resize(img, y0, x0, ch, cw, (LOCAL, LOCAL))
    want = jax.vmap(lambda im, b: _crop_resize_one(
        im, b[0], b[1], b[2], b[3], (LOCAL, LOCAL), True))(
            jnp.asarray(img.numpy()), jnp.asarray(boxes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("crops", [
    dict(size_crops=(224, 96), nmb_crops=(2, 6), min_scale_crops=(0.5,),
         max_scale_crops=(1.0, 0.5)),
    dict(size_crops=(224, 96), nmb_crops=(3, 6), min_scale_crops=(0.5, 0.14),
         max_scale_crops=(1.0, 0.5))])
def test_crop_list_checks_say_what_the_jax_package_says(crops):
    from sm3x.train.backbone_train import (make_ssl_train_step as
                                           jax_make_step)

    with pytest.raises(ValueError) as want:
        jax_make_step(None, 0, T, 1, MEAN, STD, multicrop=crops)
    with pytest.raises(ValueError) as got:
        make_ssl_train_step(None, None, 0, T, 1, MEAN, STD, multicrop=crops)
    assert str(got.value) == str(want.value)


def test_step_uses_group_zero_for_the_globals():
    """Crop group 0 sets the global views' size and scales, whatever the
    base augmentation says; `local_weight` comes from the dict."""
    crops, weight = multicrop_settings(dict(CROPS, local_weight=0.25))
    assert weight == 0.25 and crops["nmb_crops"] == (2, 3, 2)
    seen = []

    class Seen(Exception):
        pass

    class Model(torch.nn.Module):
        def forward(self, d, c, dl=(), cl=()):
            seen.append([tuple(v.shape) for v in (*d, *dl)])
            raise Seen

    canv, hw = _canvases()
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.0)
    step = make_ssl_train_step(Model(), opt, 0, T, 1, MEAN, STD,
                               multicrop=dict(CROPS, local_weight=0.25))
    with pytest.raises(Seen):
        step(canv, hw, canv, hw, 3)
    assert seen == [[(B, SIZE, SIZE, 3)] * 2 + [(B, LOCAL, LOCAL, 3)] * 3
                    + [(B, 8, 8, 3)] * 2]
