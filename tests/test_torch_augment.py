"""Augmentation in the PyTorch port (sm3x_torch.ops.augment and
augment_cuda) against the JAX package, on the CPU.

The photometric chain is held against the Pallas kernel in interpret mode
on one shared (B, 16) parameter matrix, at tests/test_augment_pallas.py's
tolerance (rtol 1e-4, atol 1e-5); the geometry against `_crop_resize_one`
with fixed boxes; the samplers by the properties of their distributions,
as tests/test_augment_props.py does for the JAX package (the generators'
numbers differ, the distributions must not).
"""

import dataclasses
from itertools import permutations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import sm3x.ops.augment as JA
from sm3x.ops.augment_pallas import photometric_pallas
from sm3x_torch.ops import augment as A
from sm3x_torch.ops import augment_cuda as K

torch.set_num_threads(2)

MEAN = (0.5, 0.45, 0.4)
STD = (0.25, 0.3, 0.2)


def _mixed_params(b, seed=0):
    """A (B, 16) matrix covering every flag combination and several op
    orders, factors drawn from the SSL distributions."""
    gen = torch.Generator().manual_seed(seed)
    params = K.build_params(gen, b, A.SSL_AUG, "cpu")
    orders = list(permutations(range(4)))
    for i in range(b):
        params[i, K.P_ORD0:K.P_ORD0 + 4] = torch.tensor(
            orders[(5 * i) % 24], dtype=torch.float32)
        for bit, col in enumerate((K.P_DO_JIT, K.P_DO_GRAY, K.P_DO_FLIP,
                                   K.P_DO_BLUR)):
            params[i, col] = float((i >> bit) & 1)
    return params


def test_photometric_plain_matches_pallas_kernel(rng_np):
    b, h, w = 16, 12, 10
    images = rng_np.random((b, h, w, 3)).astype(np.float32)
    params = _mixed_params(b)
    got = K.photometric_plain(torch.from_numpy(images), params, MEAN, STD)
    want = photometric_pallas(jnp.asarray(images), jnp.asarray(params.numpy()),
                              MEAN, STD, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_photometric_dispatch_on_cpu_is_plain(rng_np):
    images = torch.from_numpy(rng_np.random((4, 8, 8, 3)).astype(np.float32))
    params = _mixed_params(4)
    np.testing.assert_array_equal(
        K.photometric(images, params, MEAN, STD).numpy(),
        K.photometric_plain(images, params, MEAN, STD).numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        K.photometric_cuda(torch.zeros(1, 4, 4, 3), torch.zeros(1, 16), MEAN,
                           STD)


def test_crop_resize_matches_jax_with_fixed_boxes(rng_np):
    img = rng_np.random((3, 40, 36, 3)).astype(np.float32)
    boxes = np.array([[0, 0, 40, 36], [5, 7, 20, 13], [11, 2, 29, 30]],
                     np.float32)
    out_size = (24, 20)
    y0, x0, ch, cw = (torch.from_numpy(boxes[:, k]) for k in range(4))
    got = A.crop_resize(torch.from_numpy(img), y0, x0, ch, cw, out_size)
    for i in range(3):
        want = JA._crop_resize_one(jnp.asarray(img[i]), *boxes[i], out_size,
                                   True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_eval_resize_matches_jax(rng_np):
    canv = rng_np.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)
    hw = np.array([[48, 40], [30, 48]], np.int32)
    got = A.eval_resize_batch(torch.from_numpy(canv), torch.from_numpy(hw),
                              MEAN, STD, (24, 24))
    want = JA.eval_resize_batch(jnp.asarray(canv), jnp.asarray(hw), MEAN, STD,
                                (24, 24))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rrc_boxes_follow_the_jax_sampler():
    """Boxes lie inside the valid region; area scale and aspect follow the
    configured ranges; the mean area fraction matches the JAX sampler's on
    the same sizes."""
    n = 2000
    rng = np.random.default_rng(0)
    # aspects near square, so an attempt fits and the fallback stays out
    hgt = rng.integers(40, 321, n)
    hw = np.stack([hgt, np.round(hgt * rng.uniform(0.8, 1.25, n))],
                  1).astype(np.float32)
    h, w = torch.from_numpy(hw[:, 0]), torch.from_numpy(hw[:, 1])
    gen = torch.Generator().manual_seed(1)
    y0, x0, ch, cw = A.sample_rrc_boxes(gen, h, w, A.SSL_AUG)
    assert bool((y0 >= 0).all() and (x0 >= 0).all())
    assert bool((y0 + ch <= h).all() and (x0 + cw <= w).all())
    assert bool((ch >= 1).all() and (cw >= 1).all())
    frac = (ch * cw / (h * w)).numpy()
    # rounding of the sides moves the area a little off the sampled scale
    assert frac.min() > 0.45 and frac.max() <= 1.0
    ratio = (cw / ch).numpy()
    assert ratio.min() > 0.70 and ratio.max() < 1.40

    keys = jax.random.split(jax.random.key(2), n)
    jy0, jx0, jch, jcw = jax.vmap(
        lambda k, a, b: JA._sample_rrc_box(k, a, b, JA.SSL_AUG))(
            keys, jnp.asarray(hw[:, 0]), jnp.asarray(hw[:, 1]))
    jfrac = np.asarray(jch * jcw) / (hw[:, 0] * hw[:, 1])
    assert abs(frac.mean() - jfrac.mean()) < 0.02
    assert abs(ratio.mean() - np.mean(np.asarray(jcw / jch))) < 0.02


def test_rrc_fallback_is_centred_crop():
    """No attempt fits a very wide image at scale 1: torchvision's centre
    crop at the clamped aspect."""
    cfg = dataclasses.replace(A.SSL_AUG, rrc_scale=(1.0, 1.0))
    h, w = torch.tensor([10.0]), torch.tensor([100.0])
    y0, x0, ch, cw = A.sample_rrc_boxes(torch.Generator().manual_seed(0), h,
                                        w, cfg)
    jy0, jx0, jch, jcw = JA._sample_rrc_box(jax.random.key(0), 10.0, 100.0,
                                            cfg)
    assert [float(v) for v in (y0, x0, ch, cw)] == [
        float(v) for v in (jy0, jx0, jch, jcw)]


def test_build_params_distributions():
    n = 4000
    p = K.build_params(torch.Generator().manual_seed(3), n, A.SSL_AUG, "cpu")
    assert p.shape == (n, K.P_SIZE)
    order = p[:, K.P_ORD0:K.P_ORD0 + 4].long()
    assert bool((order.sort(dim=1).values == torch.arange(4)).all())
    bj, cj, sj, hj = A.SSL_AUG.jitter
    for col, lo, hi in ((K.P_FB, 1 - bj, 1 + bj), (K.P_FC, 1 - cj, 1 + cj),
                        (K.P_FS, 1 - sj, 1 + sj), (K.P_FH, -hj, hj),
                        (K.P_SIGMA, *A.SSL_AUG.blur_sigma)):
        x = p[:, col]
        assert float(x.min()) >= lo and float(x.max()) <= hi
        assert abs(float(x.mean()) - (lo + hi) / 2) < 0.05 * (hi - lo)
    for col, prob in ((K.P_DO_JIT, A.SSL_AUG.jitter_p),
                      (K.P_DO_GRAY, A.SSL_AUG.grayscale_p),
                      (K.P_DO_FLIP, A.SSL_AUG.flip_p),
                      (K.P_DO_BLUR, A.SSL_AUG.blur_p)):
        assert abs(float(p[:, col].mean()) - prob) < 0.03
    assert bool((p[:, 13:] == 0).all())


def test_no_op_config_is_plain_resize():
    rng = np.random.default_rng(0)
    canv = torch.from_numpy(rng.integers(0, 256, (4, 48, 48, 3),
                                         dtype=np.uint8))
    hw = torch.full((4, 2), 48, dtype=torch.int32)
    cfg = A.AugConfig(rrc=False, jitter_p=0, grayscale_p=0, flip_p=0,
                      blur_p=0, out_size=(24, 24))
    a = A.ssl_augment_batch(torch.Generator().manual_seed(0), canv, hw, MEAN,
                            STD, cfg)
    b = A.eval_resize_batch(canv, hw, MEAN, STD, (24, 24))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_ssl_augment_batch_shape_range_and_seed():
    rng = np.random.default_rng(1)
    canv = torch.from_numpy(rng.integers(0, 256, (6, 64, 64, 3),
                                         dtype=np.uint8))
    hw = torch.tensor([[64, 64], [40, 64], [64, 33]] * 2, dtype=torch.int32)
    cfg = dataclasses.replace(A.SSL_AUG, out_size=(32, 32))

    def run(seed):
        return A.ssl_augment_batch(torch.Generator().manual_seed(seed), canv,
                                   hw, (0, 0, 0), (1, 1, 1), cfg)

    a, b, c = run(5), run(5), run(6)
    assert a.shape == (6, 32, 32, 3)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_joint_aug_helpers():
    d = torch.tensor([[50, 60]])
    c = torch.tensor([[70, 40]])
    assert A.modality_keys(1, 2) == (1, 2)
    assert A.modality_keys(1, 2, joint_aug=True) == (1, 1)
    jd, jc = A.modality_valid_hw(d, c, joint_aug=True)
    assert jd.tolist() == jc.tolist() == [[50, 40]]
