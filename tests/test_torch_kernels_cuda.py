"""The port's CUDA kernels (K1 photometric, K2f / K2b NT-Xent) against their
plain PyTorch versions on the card, at edge shapes the smoke run does not
reach: tiny and odd image sizes, feature widths that are not a multiple of
the warp, the widest D the kernel takes, many rows per problem.

Marked `cuda`; each test skips without a card. These tests import no JAX,
so on a machine without it run them without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Float32 with TF32 off. Tolerances are the JAX package's kernel tests':
K1 rtol 1e-4 / atol 1e-5 (tests/test_augment_pallas.py), K2 loss rtol 1e-5
and gradients rtol 1e-4 / atol 1e-6 (tests/test_ntxent_pallas.py).
"""

from itertools import permutations

import numpy as np
import pytest
import torch

from sm3x_torch.ops import augment as A
from sm3x_torch.ops import augment_cuda as K1
from sm3x_torch.ops import ntxent_cuda as K2

pytestmark = pytest.mark.cuda

MEAN, STD = (0.7833, 0.6712, 0.6026), (0.2139, 0.2472, 0.2571)


@pytest.fixture(scope="module")
def card():
    """The CUDA device, with the kernels built; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sm3x_torch.ops import _native

    _native.library()
    return torch.device("cuda")


def _close(got, want, rtol, atol):
    torch.testing.assert_close(got.double().cpu(), want.double().cpu(),
                               rtol=rtol, atol=atol)


def _k1_params(batch, card, seed):
    """build_params, then every flag combination and op order in turn."""
    gen = torch.Generator(device=card).manual_seed(seed)
    params = K1.build_params(gen, batch, A.SSL_AUG, card)
    orders = list(permutations(range(4)))
    for i in range(batch):
        params[i, K1.P_ORD0:K1.P_ORD0 + 4] = torch.tensor(
            orders[(7 * i) % len(orders)], dtype=torch.float32)
        for bit, col in enumerate((K1.P_DO_JIT, K1.P_DO_GRAY, K1.P_DO_FLIP,
                                   K1.P_DO_BLUR)):
            params[i, col] = float((i >> bit) & 1)
    return params.contiguous()


@pytest.mark.parametrize("batch,h,w", [(16, 2, 2), (17, 5, 3), (16, 31, 17),
                                       (32, 64, 48)])
def test_photometric_matches_plain(card, batch, h, w):
    rng = np.random.default_rng(h * w)
    images = torch.from_numpy(rng.random((batch, h, w, 3),
                                         dtype=np.float32)).to(card)
    params = _k1_params(batch, card, seed=h)
    got = K1.photometric(images, params, MEAN, STD)
    want = K1.photometric_plain(images, params, MEAN, STD)
    torch.cuda.synchronize()
    _close(got, want, rtol=1e-4, atol=1e-5)


def test_photometric_counts_launches_and_checks_inputs(card):
    images = torch.rand(2, 8, 8, 3, device=card)
    params = _k1_params(2, card, seed=0)
    before = K1.photometric_cuda.launches
    K1.photometric(images, params, MEAN, STD)
    assert K1.photometric_cuda.launches == before + 1
    for bad in (images.double(), images[:, :, ::2], images[..., :2]):
        with pytest.raises(ValueError):
            K1.photometric_cuda(bad, params, MEAN, STD)
    with pytest.raises(ValueError):
        K1.photometric_cuda(images, params[:1], MEAN, STD)
    assert K1.photometric_cuda.launches == before + 1


@pytest.mark.parametrize("shape", [(1, 2, 1), (3, 10, 33), (8, 96, 128),
                                   (2, 64, 512), (2, 300, 64)])
@pytest.mark.parametrize("temperature", [0.1, 0.5])
def test_ntxent_kernels_match_plain(card, shape, temperature):
    rng = np.random.default_rng(sum(shape))
    z = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(card)
    g = torch.from_numpy(rng.random(shape[0], dtype=np.float32)).to(card)
    loss, lse, inv = K2.ntxent_forward_cuda(z, temperature)
    loss_p, lse_p, inv_p = K2.ntxent_forward_plain(z, temperature)
    dz = K2.ntxent_backward_cuda(z, lse, inv, g, temperature)
    dz_p = K2.ntxent_backward_plain(z, lse_p, inv_p, g, temperature)
    torch.cuda.synchronize()
    _close(loss, loss_p, rtol=1e-5, atol=1e-6)
    _close(lse, lse_p, rtol=1e-5, atol=1e-6)
    _close(inv, inv_p, rtol=1e-5, atol=1e-6)
    _close(dz, dz_p, rtol=1e-4, atol=1e-6)


def test_ntxent_function_on_card_matches_cpu_autograd(card):
    rng = np.random.default_rng(5)
    z = rng.standard_normal((4, 48, 64), dtype=np.float32)
    w = torch.from_numpy(rng.random(4, dtype=np.float32))
    zc = torch.from_numpy(z).to(card).requires_grad_(True)
    zp = torch.from_numpy(z).requires_grad_(True)
    fwd, bwd = K2.ntxent_forward_cuda.launches, K2.ntxent_backward_cuda.launches
    (K2.ntxent_problems_loss(zc, 0.1) * w.to(card)).sum().backward()
    (K2.ntxent_forward_plain(zp, 0.1)[0] * w).sum().backward()
    assert K2.ntxent_forward_cuda.launches == fwd + 1
    assert K2.ntxent_backward_cuda.launches == bwd + 1
    _close(zc.grad, zp.grad, rtol=1e-4, atol=1e-6)


def test_ntxent_kernels_check_inputs(card):
    z = torch.randn(2, 8, 16, device=card)
    for bad in (z.double(), z[:, :7], z.transpose(1, 2),
                torch.randn(1, 4, 513, device=card), z[0]):
        with pytest.raises(ValueError):
            K2.ntxent_forward_cuda(bad, 0.1)
    with pytest.raises(ValueError):
        K2.ntxent_forward_cuda(z.cpu(), 0.1)


@pytest.mark.parametrize("style", [0, 1, 2])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssl_loss_on_card_matches_cpu(card, style, groups):
    from sm3x_torch.losses.ssl import ssl_loss

    rng = np.random.default_rng(10 * style + groups)
    b, d = 8, 32
    arrays = [rng.standard_normal((2 * b, d), dtype=np.float32)
              for _ in range(2)]
    arrays += [rng.standard_normal((b, d), dtype=np.float32)
               for _ in range(4)]

    def run(dev):
        t = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in arrays]
        total, parts = ssl_loss({"derm_z": t[0], "clinic_z": t[1],
                                 "cross_derm_z": (t[2], t[3]),
                                 "cross_clinic_z": (t[4], t[5])},
                                style, 0.1, groups)
        total.backward()
        return total.detach(), parts, [x.grad for x in t]

    total_c, parts_c, grads_c = run(card)
    total_p, parts_p, grads_p = run("cpu")
    _close(total_c, total_p, rtol=1e-5, atol=1e-6)
    for k in parts_p:
        _close(parts_c[k].detach(), parts_p[k].detach(), rtol=1e-5, atol=1e-6)
    for got, want in zip(grads_c, grads_p):
        _close(got, want, rtol=1e-4, atol=1e-6)
