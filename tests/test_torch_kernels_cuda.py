"""The port's CUDA kernels (K1 photometric, K2f / K2b NT-Xent, K3f / K3b-dq /
K3b-dkv flash attention, K4 copy) against their plain PyTorch versions on
the card, at edge shapes the smoke run does not reach: tiny and odd image
sizes (K1 with the kernel each shape takes: fewer rows than a band, a
width that is no multiple of 4, bands of unequal height, more blocks than
rows, tensors off 16 bytes, a shape on the general path), feature widths
that are not a multiple of the warp, the widest D the kernel takes, many rows per problem, sequence lengths around the 64-row
tile, strided q/k/v, and copies whose length is not a multiple of 4.

Marked `cuda`; each test skips without a card. These tests import no JAX,
so on a machine without it run them without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Float32 with TF32 off. Tolerances are the JAX package's kernel tests':
K1 rtol 1e-4 / atol 1e-5 (tests/test_augment_pallas.py), K2 loss rtol 1e-5
and gradients rtol 1e-4 / atol 1e-6 (tests/test_ntxent_pallas.py), K3 in
float32 forward rtol / atol 1e-5 and gradients rtol 2e-4 / atol 2e-5
(tests/test_vit_trimodal.py:46,77); float32 runs the FMA kernels. K3 in
bf16 is held against the plain float32 version on the same bf16 inputs:
forward max abs error < 0.02 and relative Frobenius error of each gradient
< 0.03 (tests/flash_tpu_check.py). The bf16 kernels run on the tensor cores
in the TPU kernels' arithmetic, and are also held against the plain
versions in that arithmetic, rounded to bf16 as the kernels' results are:
relative Frobenius error < 5e-4 (the forward, against the plain forward
with K3f's key tile of 64, measured 8.3e-5 on an H100 at (64, 197, 12, 64),
and its lse within rtol / atol 1e-4; the backward <= 7.8e-5 at S = 1 to
257; the float32 plain versions, rounded, are 2.1e-3 to 2.6e-3 from them). K4 must
be exact.
"""

import os
from itertools import permutations

import numpy as np
import pytest
import torch

from sm3x_torch.ops import augment as A
from sm3x_torch.ops import augment_cuda as K1
from sm3x_torch.ops import attention as A3
from sm3x_torch.ops import attention_cuda as K3
from sm3x_torch.ops import copy_cuda as K4
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


@pytest.mark.parametrize("batch,h,w,kernel", [
    (96, 224, 224, "band"),   # the stage-1 shape
    (16, 5, 36, "band"),      # fewer rows than a band: one block an image
    (16, 40, 30, "band"),     # W no multiple of 4: scalar accesses
    (16, 35, 36, "band"),     # three bands of 12, 12 and 11 rows
    (16, 448, 448, "band"),   # 16 blocks of 28 + 2 rows, 161 KB each
    (16, 640, 640, "scratch"),  # a band of 40 + 2 rows does not fit
    (16, 30, 1028, "scratch"),  # a row of 257 items, a block of 256 threads
])
def test_photometric_kernel_by_shape(card, batch, h, w, kernel):
    """Which kernel a shape takes follows the plan, and both agree with the
    plain version and repeat bit for bit."""
    rng = np.random.default_rng(h + w)
    images = torch.from_numpy(rng.random((batch, h, w, 3),
                                         dtype=np.float32)).to(card)
    params = _k1_params(batch, card, seed=w)
    assert K1.photometric_plan(h, w)["kernel"] == kernel
    before = dict(K1.photometric_cuda.variants)
    got = K1.photometric_cuda(images, params, MEAN, STD)
    again = K1.photometric_cuda(images, params, MEAN, STD)
    want = K1.photometric_plain(images, params, MEAN, STD)
    torch.cuda.synchronize()
    other = "scratch" if kernel == "band" else "band"
    assert K1.photometric_cuda.variants == {kernel: before[kernel] + 2,
                                            other: before[other]}
    _close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got, again)


def test_photometric_band_kernel_with_idle_blocks(card):
    """Called past the plan with more blocks than rows (8 blocks of one row
    for 5 rows): the blocks past the last row hold nothing and still meet
    the cluster's barriers."""
    from sm3x_torch.ops import _native

    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.random((16, 5, 36, 3),
                                         dtype=np.float32)).to(card)
    params = _k1_params(16, card, seed=3)
    out = torch.empty_like(images)
    for px in (4, 1):
        _native.check(_native.library().sm3x_photometric_band(
            images.data_ptr(), params.data_ptr(), out.data_ptr(), 16, 5, 36,
            8, 1, px, 64, *MEAN, *STD, _native.stream_handle(images.device)),
            "sm3x_photometric_band")
        torch.cuda.synchronize()
        _close(out, K1.photometric_plain(images, params, MEAN, STD),
               rtol=1e-4, atol=1e-5)


def test_photometric_reads_tensors_off_16_bytes(card):
    """Contiguous images 4 bytes off a 16-byte address take the band kernel
    with scalar accesses (another order of summation for the mean gray than
    the 16-byte path, so other last bits), and repeat bit for bit."""
    rng = np.random.default_rng(4)
    flat = torch.from_numpy(rng.random(16 * 24 * 32 * 3 + 1,
                                       dtype=np.float32)).to(card)
    off = flat[1:].view(16, 24, 32, 3)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    params = _k1_params(16, card, seed=4)
    want = K1.photometric_plain(off, params, MEAN, STD)
    got = K1.photometric_cuda(off, params, MEAN, STD)
    again = K1.photometric_cuda(off, params, MEAN, STD)
    aligned = K1.photometric_cuda(off.clone(), params, MEAN, STD)
    torch.cuda.synchronize()
    _close(got, want, rtol=1e-4, atol=1e-5)
    _close(aligned, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got, again)


def test_photometric_order_with_two_contrast_rounds(card):
    """An op order is a permutation when `build_params` draws it; an order
    that names contrast more than once still gives the plain version's
    result, with one whole-image mean for each contrast round."""
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.random((8, 40, 36, 3),
                                         dtype=np.float32)).to(card)
    params = _k1_params(8, card, seed=5)
    params[:, K1.P_DO_JIT] = 1.0
    for i, order in enumerate(((1, 1, 1, 1), (1, 3, 1, 0), (0, 1, 2, 1),
                               (3, 3, 3, 3), (1, 0, 2, 3), (2, 1, 1, 0),
                               (0, 0, 0, 0), (2, 2, 1, 2))):
        params[i, K1.P_ORD0:K1.P_ORD0 + 4] = torch.tensor(
            order, dtype=torch.float32)
    got = K1.photometric_cuda(images, params, MEAN, STD)
    torch.cuda.synchronize()
    _close(got, K1.photometric_plain(images, params, MEAN, STD), rtol=1e-4,
           atol=1e-5)


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


# the last five are K2b's: D beyond 512 (two tiles of 32-column blocks),
# the widest D of the tests, rows that stream tiles at a wide D, an odd
# unaligned D, one problem; then multi-crop's 16 terms and the tri-modal
# loss's 9 terms (batch 64), each in two groups
@pytest.mark.parametrize("shape", [(1, 2, 1), (3, 10, 33), (8, 96, 128),
                                   (2, 64, 512), (2, 300, 64), (8, 96, 640),
                                   (2, 96, 1024), (2, 300, 520), (3, 14, 131),
                                   (1, 96, 128), (32, 96, 128),
                                   (18, 64, 128)])
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


@pytest.mark.parametrize("shape", [(8, 96, 128), (3, 10, 33), (2, 300, 64),
                                   (2, 700, 512)])
def test_ntxent_forward_repeats_bit_for_bit(card, shape):
    """One launch, no float atomics: the same input gives the same bits,
    also where the rows' tiles are streamed ((700, 512): 8 tiles of 96)."""
    rng = np.random.default_rng(sum(shape))
    z = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(card)
    first = K2.ntxent_forward_cuda(z, 0.1)
    second = K2.ntxent_forward_cuda(z, 0.1)
    want = K2.ntxent_forward_plain(z, 0.1)
    torch.cuda.synchronize()
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)
        _close(a, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(8, 96, 128), (8, 96, 640), (3, 14, 131),
                                   (2, 300, 520), (2, 700, 512), (1, 96, 128)])
def test_ntxent_backward_repeats_bit_for_bit(card, shape):
    """Fixed-order sums and no float atomics in K2b: the same input gives
    the same bits, also where tiles are streamed and partial rows carried
    from tile to tile ((700, 512): 11 tiles of 64 rows)."""
    rng = np.random.default_rng(sum(shape))
    z = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(card)
    g = torch.from_numpy(rng.random(shape[0], dtype=np.float32)).to(card)
    _, lse, inv = K2.ntxent_forward_plain(z, 0.1)
    first = K2.ntxent_backward_cuda(z, lse, inv, g, 0.1)
    second = K2.ntxent_backward_cuda(z, lse, inv, g, 0.1)
    want = K2.ntxent_backward_plain(z, lse, inv, g, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _close(first, want, rtol=1e-4, atol=1e-6)


def test_ntxent_backward_reads_tensors_off_16_bytes(card):
    rng = np.random.default_rng(8)
    flat = torch.from_numpy(rng.standard_normal(2 * 48 * 64 + 1,
                                                dtype=np.float32)).to(card)
    off = flat[1:].view(2, 48, 64)
    assert off.data_ptr() % 16 == 4
    g = torch.ones(2, device=card)
    _, lse, inv = K2.ntxent_forward_plain(off, 0.1)
    got = K2.ntxent_backward_cuda(off, lse, inv, g, 0.1)
    aligned = K2.ntxent_backward_cuda(off.clone(), lse, inv, g, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)


def test_ntxent_function_takes_a_projection_wider_than_512(card):
    """--proj-dim 640: the reference gives a loss at any width, and so does
    the port on the card, forward and backward through the kernels."""
    rng = np.random.default_rng(640)
    z = rng.standard_normal((8, 96, 640), dtype=np.float32)
    w = torch.from_numpy(rng.random(8, dtype=np.float32))
    zc = torch.from_numpy(z).to(card).requires_grad_(True)
    zp = torch.from_numpy(z).requires_grad_(True)
    fwd, bwd = K2.ntxent_forward_cuda.launches, K2.ntxent_backward_cuda.launches
    loss = K2.ntxent_problems_loss(zc, 0.1)
    (loss * w.to(card)).sum().backward()
    loss_p = K2.ntxent_forward_plain(zp, 0.1)[0]
    (loss_p * w).sum().backward()
    assert K2.ntxent_forward_cuda.launches == fwd + 1
    assert K2.ntxent_backward_cuda.launches == bwd + 1
    _close(loss, loss_p, rtol=1e-5, atol=1e-6)
    _close(zc.grad, zp.grad, rtol=1e-4, atol=1e-6)


def test_ntxent_forward_reads_tensors_off_16_bytes(card):
    rng = np.random.default_rng(6)
    flat = torch.from_numpy(rng.standard_normal(2 * 48 * 64 + 1,
                                                dtype=np.float32)).to(card)
    off = flat[1:].view(2, 48, 64)
    assert off.data_ptr() % 16 == 4
    got = K2.ntxent_forward_cuda(off, 0.1)
    aligned = K2.ntxent_forward_cuda(off.clone(), 0.1)
    torch.cuda.synchronize()
    for a, b in zip(got, aligned):
        assert torch.equal(a, b)


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
                z[0]):
        with pytest.raises(ValueError):
            K2.ntxent_forward_cuda(bad, 0.1)
    # D is bounded by a block's shared memory alone: 1312 floats a row
    wide = torch.randn(1, 4, 1313, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        K2.ntxent_forward_cuda(wide, 0.1)
    with pytest.raises(ValueError, match="shared memory"):
        K2.ntxent_backward_cuda(
            torch.randn(1, 4, 2000, device=card), torch.zeros(1, 4, device=card),
            torch.ones(1, 4, device=card), torch.ones(1, device=card), 0.1)
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


@pytest.mark.parametrize("kind", ["multicrop", "trimodal"])
def test_multicrop_and_trimodal_losses_on_card_match_cpu(card, kind):
    """The local term and the tri-modal loss: every term and group in one
    K2f and one K2b launch, against the plain versions on the CPU."""
    from sm3x_torch.losses.ssl import ssl_loss
    from sm3x_torch.models.trimodal import trimodal_ssl_loss

    rng = np.random.default_rng(7)
    b, d = 16, 32
    n_half = 8 if kind == "multicrop" else 6  # B-row projections
    arrays = [rng.standard_normal((2 * b, d), dtype=np.float32)
              for _ in range(2)]
    arrays += [rng.standard_normal((b, d), dtype=np.float32)
               for _ in range(n_half)]

    def run(dev):
        t = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in arrays]
        outs = {"derm_z": t[0], "clinic_z": t[1],
                "cross_derm_z": (t[2], t[3]), "cross_clinic_z": (t[4], t[5])}
        if kind == "multicrop":
            outs["derm_local_z"], outs["clinic_local_z"] = (t[6], t[7]), (
                t[8], t[9])
            total, parts = ssl_loss(outs, 0, 0.1, 2, local_weight=0.5)
        else:
            outs["cross_meta_z"] = (t[6], t[7])
            total, parts = trimodal_ssl_loss(outs, 0.1, 2)
        total.backward()
        return total.detach(), parts, [x.grad for x in t]

    before = (K2.ntxent_forward_cuda.launches,
              K2.ntxent_backward_cuda.launches)
    total_c, parts_c, grads_c = run(card)
    assert (K2.ntxent_forward_cuda.launches,
            K2.ntxent_backward_cuda.launches) == (before[0] + 1,
                                                  before[1] + 1)
    total_p, parts_p, grads_p = run("cpu")
    _close(total_c, total_p, rtol=1e-5, atol=1e-6)
    for k in parts_p:
        _close(parts_c[k].detach(), parts_p[k].detach(), rtol=1e-5, atol=1e-6)
    for got, want in zip(grads_c, grads_p):
        _close(got, want, rtol=1e-4, atol=1e-6)


def _qkv(shape, dtype, card, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(card, dtype) for _ in range(4)]


def _rel(got, want):
    """Relative Frobenius error; the 1e-3 keeps a gradient that is zero in
    exact arithmetic (dq and dk at S = 1) from dividing rounding by zero."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / (want.norm() + 1e-3))


def _rel_bf16(got, want):
    """Relative Frobenius error against `want` rounded to bf16; the floor of
    1e-3 a element keeps a gradient that vanishes in exact arithmetic (dq
    and dk at S = 1) from dividing rounding by zero."""
    got, want = got.double().cpu(), want.bfloat16().double().cpu()
    return float((got - want).norm()
                 / (want.norm() + 1e-3 * want.numel() ** 0.5))


# S = 37: a ViT-B/16's multi-crop local view (96 x 96: 36 patches and the
# class token)
@pytest.mark.parametrize("s", [1, 63, 64, 65, 197, 257, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(card, s, dtype):
    b, h, d = 8, 12, 64
    q, k, v, do = _qkv((b, s, h, d), dtype, card, seed=s)
    scale = 1 / 8.0
    out, lse = K3.flash_forward_cuda(q, k, v, scale)
    dq, delta = K3.flash_backward_dq_cuda(q, k, v, out, do, lse, scale)
    dk, dv = K3.flash_backward_dkv_cuda(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    out_p, lse_p = A3.attention_plain(*f[:3], scale)
    grads_p = A3.attention_backward_plain(*f[:3], out_p, f[3], lse_p, scale)
    if dtype == torch.float32:
        _close(out, out_p, rtol=1e-5, atol=1e-5)
        _close(lse, lse_p, rtol=1e-5, atol=1e-5)
        _close(delta, (f[3] * out_p).sum(-1).transpose(1, 2), rtol=1e-5,
               atol=1e-5)
        for got, want in zip((dq, dk, dv), grads_p):
            _close(got, want, rtol=2e-4, atol=2e-5)
    else:
        assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
        assert float((out.float() - out_p).abs().max()) < 0.02
        out_bf16, lse_bf16 = A3.attention_plain(
            *f[:3], scale, operand_dtype=torch.bfloat16, block_k=K3.KEY_TILE)
        assert _rel_bf16(out, out_bf16) < 5e-4
        _close(lse, lse_bf16, rtol=1e-4, atol=1e-4)
        _close(lse, lse_p, rtol=1e-4, atol=1e-4)
        for got, want in zip((dq, dk, dv), grads_p):
            assert _rel(got, want) < 0.03
        # the same out and lse as the kernels were given
        grads_bf16 = A3.attention_backward_plain(
            *f[:3], out.float(), f[3], lse, scale,
            operand_dtype=torch.bfloat16)
        for got, want in zip((dq, dk, dv), grads_bf16):
            assert _rel_bf16(got, want) < 5e-4


def test_flash_plain_backward_is_autograd_of_plain_forward(card):
    q, k, v, do = _qkv((4, 197, 3, 64), torch.float32, card, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = A3.attention_plain(*leaves, 0.125)
    out.backward(do)
    grads = A3.attention_backward_plain(q, k, v, out.detach(), do, lse, 0.125)
    for got, leaf in zip(grads, leaves):
        _close(got, leaf.grad, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_reads_strided_inputs(card, dtype):
    """q, k, v as views of one packed (B, S, 3, H, D) tensor, and an output
    gradient that is a transposed view: the kernels read the strides, and
    give the bits they give on contiguous copies."""
    b, s, h, d = 3, 100, 4, 64
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, d),
                                               dtype=np.float32)).to(card,
                                                                     dtype)
    q, k, v = qkv.unbind(2)
    do = torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32)
                          ).to(card, dtype).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    out, lse = K3.flash_forward_cuda(q, k, v, 0.125)
    dq, delta = K3.flash_backward_dq_cuda(q, k, v, out, do, lse, 0.125)
    dk, dv = K3.flash_backward_dkv_cuda(q, k, v, do, lse, delta, 0.125)
    c = [t.contiguous() for t in (q, k, v, do)]
    out_c, lse_c = K3.flash_forward_cuda(*c[:3], 0.125)
    dq_c, delta_c = K3.flash_backward_dq_cuda(*c[:3], out_c, c[3], lse_c,
                                              0.125)
    grads_c = (dq_c,) + K3.flash_backward_dkv_cuda(*c[:3], c[3], lse_c,
                                                   delta_c, 0.125)
    f = [t.float() for t in c]
    out_p, lse_p = A3.attention_plain(*f[:3], 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    for got, want in zip((dq, dk, dv), grads_c):
        assert torch.equal(got, want)
    if dtype == torch.float32:
        _close(out, out_p, rtol=1e-5, atol=1e-5)
        grads_p = A3.attention_backward_plain(*f[:3], out_p, f[3], lse_p,
                                              0.125)
        for got, want in zip((dq, dk, dv), grads_p):
            _close(got, want, rtol=2e-4, atol=2e-5)
    else:
        out_b, _ = A3.attention_plain(*f[:3], 0.125,
                                      operand_dtype=torch.bfloat16,
                                      block_k=K3.KEY_TILE)
        assert _rel_bf16(out, out_b) < 5e-4
        grads_p = A3.attention_backward_plain(
            *f[:3], out.float(), f[3], lse, 0.125,
            operand_dtype=torch.bfloat16)
        for got, want in zip((dq, dk, dv), grads_p):
            assert _rel_bf16(got, want) < 5e-4


def test_flash_backward_refuses_bf16_rows_off_16_bytes(card):
    """The tensor-core K3b copies and reads 16-byte row starts: a bf16
    input 2 bytes off, or with rows 68 elements apart, raises ValueError
    and launches nothing. float32 inputs laid out the same way run: the FMA
    kernels read any stride."""
    b, s, h, d = 2, 70, 3, 64
    n = b * s * h * d

    def layouts(dtype):  # 2 or 4 bytes off; rows 68 elements apart
        return (torch.randn(n + 1, device=card, dtype=dtype)[1:].view(
            b, s, h, d),
                torch.randn(b, s, h, d + 4, device=card, dtype=dtype)[..., :d])

    lse = torch.zeros(b, h, s, device=card)
    before = [K3.flash_backward_dq_cuda.launches,
              K3.flash_backward_dkv_cuda.launches]
    for x in layouts(torch.bfloat16):
        with pytest.raises(ValueError, match="16-byte"):
            K3.flash_backward_dq_cuda(x, x, x, x, x, lse, 0.125)
        with pytest.raises(ValueError, match="16-byte"):
            K3.flash_backward_dkv_cuda(x, x, x, x, lse, lse, 0.125)
    assert [K3.flash_backward_dq_cuda.launches,
            K3.flash_backward_dkv_cuda.launches] == before
    q, k = layouts(torch.float32)
    out, lse = K3.flash_forward_cuda(q, k, k, 0.125)
    dq, delta = K3.flash_backward_dq_cuda(q, k, k, out, q, lse, 0.125)
    dk, dv = K3.flash_backward_dkv_cuda(q, k, k, q, lse, delta, 0.125)
    out_p, lse_p = A3.attention_plain(q, k, k, 0.125)
    grads_p = A3.attention_backward_plain(q, k, k, out_p, q, lse_p, 0.125)
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv), grads_p):
        _close(got, want, rtol=2e-4, atol=2e-5)


def test_flash_forward_refuses_bf16_rows_off_16_bytes(card):
    """The tensor-core K3f copies and reads 16-byte row starts, as K3b: a
    bf16 input 2 bytes off, or with rows 68 elements apart, raises
    ValueError and launches nothing, also through the autograd Function
    (no plain version takes over on the card)."""
    b, s, h, d = 2, 70, 3, 64
    off = torch.randn(b * s * h * d + 1, device=card,
                      dtype=torch.bfloat16)[1:].view(b, s, h, d)
    wide = torch.randn(b, s, h, d + 4, device=card,
                       dtype=torch.bfloat16)[..., :d]
    good = torch.randn(b, s, h, d, device=card, dtype=torch.bfloat16)
    before = K3.flash_forward_cuda.launches
    for bad in (off, wide):
        for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
            with pytest.raises(ValueError, match="16-byte"):
                K3.flash_forward_cuda(*args, 0.125)
        with pytest.raises(ValueError, match="16-byte"):
            A3.flash_attention(bad, good, good)
    assert K3.flash_forward_cuda.launches == before
    K3.flash_forward_cuda(good, good, good, 0.125)
    assert K3.flash_forward_cuda.launches == before + 1


def test_flash_backward_runs_fma_for_float32_and_mma_for_bf16(card):
    """Counted per kernel on the wrappers, directly and through the autograd
    Function: float32 runs the FMA kernels, bf16 the tensor-core ones, the
    forward as the backward."""
    k3b = (K3.flash_forward_cuda, K3.flash_backward_dq_cuda,
           K3.flash_backward_dkv_cuda)
    for dtype, kind in ((torch.float32, "fma"), (torch.bfloat16, "mma")):
        q, k, v, do = _qkv((2, 65, 3, 64), dtype, card, seed=2)
        before = [dict(fn.variants) for fn in k3b]
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        A3.flash_attention(*leaves).backward(do)
        out, lse = K3.flash_forward_cuda(q, k, v, 0.125)
        _, delta = K3.flash_backward_dq_cuda(q, k, v, out, do, lse, 0.125)
        K3.flash_backward_dkv_cuda(q, k, v, do, lse, delta, 0.125)
        for fn, was in zip(k3b, before):
            want = dict(was)
            want[kind] += 2
            assert fn.variants == want


def test_flash_function_on_card_matches_cpu_and_counts(card):
    q, k, v, do = _qkv((2, 197, 12, 64), torch.float32, card, seed=3)
    counters = (K3.flash_forward_cuda, K3.flash_backward_dq_cuda,
                K3.flash_backward_dkv_cuda)
    before = [fn.launches for fn in counters]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    A3.flash_attention(*leaves).backward(do)
    assert [fn.launches for fn in counters] == [n + 1 for n in before]
    cpu = [t.cpu().requires_grad_(True) for t in (q, k, v)]
    out_c = A3.attention_xla(*cpu)
    out_c.backward(do.cpu())
    for leaf, want in zip(leaves, cpu):
        _close(leaf.grad, want.grad, rtol=2e-4, atol=2e-5)


def test_flash_kernels_check_inputs(card):
    q = torch.randn(2, 10, 3, 64, device=card)
    before = K3.flash_forward_cuda.launches
    for bad in (torch.randn(2, 10, 3, 32, device=card),
                torch.randn(2, 10, 3, 128, device=card), q.double(),
                q.half(), q.cpu(),
                torch.randn(2, 10, 3, 128, device=card)[..., ::2]):
        with pytest.raises(ValueError):
            K3.flash_forward_cuda(bad, bad, bad, 0.125)
    with pytest.raises(ValueError):  # shapes that differ
        K3.flash_forward_cuda(q, q[:, :5], q[:, :5], 0.125)
    with pytest.raises(ValueError):  # dtypes that differ
        K3.flash_forward_cuda(q, q.bfloat16(), q, 0.125)
    with pytest.raises(ValueError):  # a D != 64 input raises on the card
        A3.flash_attention(*(torch.randn(2, 10, 3, 32, device=card),) * 3)
    assert K3.flash_forward_cuda.launches == before


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097, 1_000_003, 3 * 2 ** 20 + 2])
def test_copy_kernel_is_exact(card, n):
    x = torch.randn(n + 1, device=card)
    for src in (x[:n], x[1:]):  # 16-byte aligned, and 4 bytes off
        before = K4.copy_cuda.launches
        y = K4.copy(src)
        torch.cuda.synchronize()
        assert K4.copy_cuda.launches == before + 1
        assert y.shape == src.shape and torch.equal(y, src)


def test_copy_kernel_checks_inputs(card):
    with pytest.raises(ValueError):
        K4.copy_cuda(torch.zeros(4, device=card, dtype=torch.float64))
    with pytest.raises(ValueError):
        K4.copy_cuda(torch.zeros(4, 4, device=card).t())
    with pytest.raises(ValueError):
        K4.copy_cuda(torch.zeros(4))


def test_flash_kernels_repeat_bit_for_bit(card):
    """No float atomics: the same inputs give the same bits."""
    q, k, v, do = _qkv((4, 197, 12, 64), torch.bfloat16, card, seed=11)
    runs = []
    for _ in range(2):
        out, lse = K3.flash_forward_cuda(q, k, v, 0.125)
        dq, delta = K3.flash_backward_dq_cuda(q, k, v, out, do, lse, 0.125)
        dk, dv = K3.flash_backward_dkv_cuda(q, k, v, do, lse, delta, 0.125)
        runs.append((out, lse, dq, dk, dv))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_vit_with_flash_on_card_matches_cpu(card):
    """A cut ViT (dim 128, depth 2, 2 heads) with --use-checkpoint flash:
    float32 on the card through K3 against float64 on the CPU through the
    plain versions, from the same weights, under a fixed projection of the
    features (gradients at the JAX package's rtol 2e-4 / atol 2e-5; the
    projection is scaled so that the largest gradients are of order 1, the
    scale that atol is meant for)."""
    from sm3x_torch.models.vit import ViT

    torch.manual_seed(0)
    cpu = ViT(patch=16, dim=128, depth=2, n_heads=2, remat="flash",
              img_size=32).double()
    gpu = ViT(patch=16, dim=128, depth=2, n_heads=2, remat="flash",
              img_size=32)
    gpu.load_state_dict({k: v.float() for k, v in cpu.state_dict().items()})
    gpu.to(card)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 32, 32, 3)))
    proj = torch.from_numpy(rng.standard_normal((3, 128))) / 100
    before = K3.flash_backward_dkv_cuda.launches
    (gpu(x.float().to(card)) * proj.float().to(card)).sum().backward()
    assert K3.flash_backward_dkv_cuda.launches == before + 2
    (cpu(x) * proj).sum().backward()
    for p, q in zip(gpu.parameters(), cpu.parameters()):
        _close(p.grad, q.grad, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# The supervised stages: K1 under the finetune and probe presets, and a
# supervised train step on the card against the CPU's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["FINETUNE_AUG", "PROBE_AUG"])
@pytest.mark.parametrize("batch,size", [(128, 224), (5, 37)])
def test_photometric_at_the_supervised_presets(card, preset, batch, size):
    """The parameter rows `build_params` draws from the supervised presets
    gate off jitter, grayscale and blur on every image: flip and normalise
    are all K1 does, and it does them as its plain version."""
    cfg = getattr(A, preset)
    gen = torch.Generator(device=card).manual_seed(3)
    params = K1.build_params(gen, batch, cfg, card)
    assert not bool(params[:, [K1.P_DO_JIT, K1.P_DO_GRAY,
                               K1.P_DO_BLUR]].any())
    assert 0 < float(params[:, K1.P_DO_FLIP].sum()) < batch
    images = torch.rand((batch, size, size, 3), device=card,
                        generator=torch.Generator(device=card).manual_seed(4))
    before = dict(K1.photometric_cuda.variants)
    got = K1.photometric_cuda(images, params, MEAN, STD)
    assert K1.photometric_cuda.variants["band"] == before["band"] + 1
    _close(got, K1.photometric_plain(images, params, MEAN, STD),
           rtol=1e-4, atol=1e-5)
    # what is left of the chain, written out: a flip, then the normalise
    flipped = torch.where(params[:, K1.P_DO_FLIP, None, None, None] > 0.5,
                          images.flip(2), images)
    _close(got, A.normalize_images(flipped, MEAN, STD), rtol=1e-4, atol=1e-5)


def test_photometric_at_the_local_views(card):
    """Multi-crop's six 96 x 96 local views of a batch of 96 in one launch,
    (576, 96, 96, 3) under the SSL parameter rows: the band kernel, as its
    plain version; and `multicrop_augment_batch` on the card gives each
    view what a launch of its own gives it, bit for bit, in one K1 launch
    a group."""
    from sm3x_torch.core import prng

    images = torch.rand((576, 96, 96, 3), device=card,
                        generator=torch.Generator(device=card).manual_seed(4))
    gen = torch.Generator(device=card).manual_seed(3)
    params = K1.build_params(gen, 576, A.SSL_AUG, card)
    before = dict(K1.photometric_cuda.variants)
    got = K1.photometric_cuda(images, params, MEAN, STD)
    assert K1.photometric_cuda.variants == dict(before,
                                                band=before["band"] + 1)
    _close(got, K1.photometric_plain(images, params, MEAN, STD),
           rtol=1e-4, atol=1e-5)

    rng = np.random.default_rng(5)
    canv = torch.from_numpy(rng.integers(0, 256, (8, 120, 120, 3),
                                         dtype=np.uint8)).to(card)
    hw = torch.from_numpy(rng.integers(60, 121, (8, 2)).astype(
        np.int32)).to(card)
    crops = dict(size_crops=(64, 32), nmb_crops=(2, 3),
                 min_scale_crops=(0.5, 0.14), max_scale_crops=(1.0, 0.5))
    launches = K1.photometric_cuda.launches
    views = A.multicrop_augment_batch(9, canv, hw, MEAN, STD, **crops)
    assert K1.photometric_cuda.launches == launches + 2
    import dataclasses

    for idx in range(5):
        group = int(idx >= 2)
        cfg = dataclasses.replace(
            A.SSL_AUG, out_size=(crops["size_crops"][group],) * 2,
            rrc_scale=(crops["min_scale_crops"][group],
                       crops["max_scale_crops"][group]))
        want = A.ssl_augment_batch(prng.generator(prng.fold_in(9, idx), card),
                                   canv, hw, MEAN, STD, cfg)
        assert torch.equal(views[idx], want), idx


@pytest.mark.parametrize("finetune", ["projector", "all"])
def test_supervised_train_step_on_card_matches_cpu(card, finetune):
    """One update of the MLC eval model (resnet18, 64x64, batch 8, dropout
    0) on the card against the same update on the CPU, from the same
    weights, labels and views; the views come from K1 on the card."""
    import dataclasses

    from sm3x_torch.models.mlc import MLCModel
    from sm3x_torch.train import common, supervised
    from sm3x_torch.train.mlc_train import augment_pair
    from sm3x_torch.data.synthetic import SyntheticPairedData

    torch.manual_seed(0)
    cpu_model = MLCModel("resnet18", proj_dim=32, sa_dim_ff=16,
                         sa_dropout=0.0, use_prototype_bias=True)
    gpu_model = MLCModel("resnet18", proj_dim=32, sa_dim_ff=16,
                         sa_dropout=0.0, use_prototype_bias=True)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(card)
    data = SyntheticPairedData(8, canvas=96, seed=4)
    aug = dataclasses.replace(A.FINETUNE_AUG, out_size=(64, 64))
    before = K1.photometric_cuda.launches
    d, c = augment_pair(11, *(torch.from_numpy(x).to(card) for x in (
        data.derm, data.derm_hw, data.clinic, data.clinic_hw)), MEAN, STD,
        aug, False)
    assert K1.photometric_cuda.launches == before + 2
    labels = torch.from_numpy(data.labels).long()
    out = {}
    for name, model, dev in (("cpu", cpu_model, "cpu"),
                             ("cuda", gpu_model, card)):
        opt = common.make_adamw(common.trainable_parameters(
            model, lambda n: common.mlc_eval_trainable(n, finetune)),
            1e-3, 5e-2)
        forward = lambda a, b, gen, model=model: model(
            a, b, extractor_train=finetune == "all", head_train=True,
            stop_extractor_grad=finetune != "all", generator=gen)[1]
        out[name] = supervised.supervised_update(
            forward, opt, d.to(dev), c.to(dev), labels.to(dev), (1.0,) * 8)
    _close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-5)
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        _close(got, want, rtol=1e-3, atol=1e-4)
    worst = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(gpu_model.parameters(),
                                cpu_model.parameters()))
    assert worst <= 3e-3  # Adam's update is about lr whatever the gradient
    frozen = [n for n, p in gpu_model.named_parameters()
              if not p.requires_grad]
    assert frozen and all(
        torch.equal(gpu_model.state_dict()[n].cpu(),
                    cpu_model.state_dict()[n]) for n in frozen)


# ---------------------------------------------------------------------------
# Serving and the data feed on the card (no kernel of the port runs in
# them; the CUDA graphs, the pinned ring and the side stream exist only here)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_predictor(card):
    from sm3x_torch.api import build_evaluator
    from sm3x_torch.serve import Predictor

    torch.manual_seed(0)
    model = build_evaluator("resnet18", mlc_proj_dim=32, sa_dim_ff=16)
    model.to(card).to(memory_format=torch.channels_last)
    return Predictor(model, MEAN, STD, test_sz=64, buckets=(1, 4, 16),
                     canvas=96)


def _raw(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (int(rng.integers(60, 140)),
                                  int(rng.integers(60, 140)), 3),
                         dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 3, 4, 16, 21])
def test_graph_replay_equals_the_eager_forward(small_predictor, n):
    """Every bucket's graph against the eager forward on the same padded
    canvases (rtol / atol 1e-5), rows summing to 1; 21 cases take bucket 16
    twice."""
    p = small_predictor
    assert sorted(p._graphs) == [1, 4, 16]
    seen = []
    call = p._call

    def spy(b, *arrays):
        out = call(b, *arrays)
        seen.append((b, arrays, np.concatenate(out, -1)))
        return out

    p._call = spy
    try:
        out = p.predict(_raw(n, n), _raw(n, 50 + n))
    finally:
        del p._call
    assert [b for b, _, _ in seen] == {1: [1], 3: [4], 4: [4], 16: [16],
                                       21: [16, 16]}[n]
    assert out[0].shape == (n, 5)
    for head in out:
        np.testing.assert_allclose(head.sum(-1), 1.0, rtol=1e-5)
    for b, arrays, packed in seen:
        eager = p._forward(*(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                             for a in arrays))
        _close(torch.from_numpy(packed), eager, rtol=1e-5, atol=1e-5)


def test_graph_replay_is_safe_from_another_thread(small_predictor):
    import threading

    p = small_predictor
    derm, clinic = _raw(3, 7), _raw(3, 8)
    want = p.predict(derm, clinic)
    got = []
    t = threading.Thread(target=lambda: got.append(p.predict(derm, clinic)))
    t.start()
    t.join(60)
    assert got and all(np.array_equal(a, b) for a, b in zip(got[0], want))


@pytest.fixture(scope="module")
def small_artifact(small_predictor, tmp_path_factory):
    """`small_predictor`'s model (bf16) exported on the card, buckets 1 and
    4."""
    from sm3x_torch.export import export_predictor

    path = str(tmp_path_factory.mktemp("aot") / "artifact")
    export_predictor(small_predictor.model, path, buckets=(1, 4),
                     image_size=64, mean=MEAN, std=STD, canvas=96)
    return path


@pytest.mark.parametrize("n", [1, 3, 6])
def test_exported_graphs_serve_what_the_live_predictor_does(
        small_predictor, small_artifact, n):
    """The artifact loaded on the card: one CUDA graph a bucket, each
    against the loaded program run eagerly on the same canvases (rtol /
    atol 1e-5) and against the live Predictor's graphs (bf16: atol 1e-4,
    another capture may pick other cuDNN algorithms); 6 cases take bucket 4
    twice."""
    from sm3x_torch.export import ExportedPredictor

    p = ExportedPredictor(small_artifact)
    assert p.device.type == "cuda" and sorted(p._graphs) == [1, 4]
    seen = []
    call = p._call

    def spy(b, *arrays):
        out = call(b, *arrays)
        seen.append((b, arrays, np.concatenate(out, -1)))
        return out

    p._call = spy
    derm, clinic = _raw(n, 70 + n), _raw(n, 90 + n)
    out = p.predict(derm, clinic)
    assert [b for b, _, _ in seen] == {1: [1], 3: [4], 6: [4, 4]}[n]
    for b, arrays, packed in seen:
        eager = p._program(b)(*(torch.from_numpy(np.ascontiguousarray(a))
                                .cuda() for a in arrays))
        _close(torch.from_numpy(packed), eager, rtol=1e-5, atol=1e-5)
    live = small_predictor.predict(derm, clinic)
    _close(torch.from_numpy(np.concatenate(out, -1)),
           torch.from_numpy(np.concatenate(live, -1)), rtol=0, atol=1e-4)


def test_an_artifact_for_the_cpu_is_refused_on_the_card(small_predictor,
                                                        tmp_path):
    from sm3x_torch.export import ExportedPredictor, export_predictor

    path = str(tmp_path / "cpu")
    export_predictor(small_predictor.model, path, buckets=(1,),
                     image_size=64, mean=MEAN, std=STD, canvas=96,
                     platforms=("cpu",))
    assert sorted(os.listdir(path)) == ["fwd_b1_cpu.pt2", "manifest.json"]
    with pytest.raises(ValueError, match="cuda"):
        ExportedPredictor(path)
    # and it runs where it was exported for
    probs = ExportedPredictor(path, device="cpu").predict(_raw(1, 5),
                                                          _raw(1, 6))
    np.testing.assert_allclose(probs[0].sum(-1), 1.0, rtol=1e-5)


def test_nan_checks_on_the_card_and_under_graph_capture(small_predictor):
    """Under enable_nan_checks a NaN made on the card raises, in a forward
    pass and in a backward pass (run on autograd's device thread); a new
    Predictor captures its graphs under the switch and serves what
    `small_predictor` does (atol 1e-4: another capture may pick other cuDNN
    algorithms)."""
    from sm3x_torch.serve import Predictor
    from sm3x_torch.utils import profiling

    derm, clinic = _raw(3, 11), _raw(3, 12)
    want = small_predictor.predict(derm, clinic)
    x = torch.zeros(1, device="cuda", requires_grad=True)
    try:
        profiling.enable_nan_checks()
        with pytest.raises(FloatingPointError, match="nan"):
            torch.sqrt(torch.full((1,), -1.0, device="cuda")) * 2
        with pytest.raises(FloatingPointError, match="nan"):
            (torch.sqrt(x) * 0).sum().backward()
        p = Predictor(small_predictor.model, MEAN, STD, test_sz=64,
                      buckets=(1, 4, 16), canvas=96)
        assert sorted(p._graphs) == [1, 4, 16]
        got = p.predict(derm, clinic)
    finally:
        profiling.enable_nan_checks(False)
    _close(torch.from_numpy(np.concatenate(got, -1)),
           torch.from_numpy(np.concatenate(want, -1)), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def paired(card):
    from sm3x_torch.data.synthetic import synthetic_paired_data

    return synthetic_paired_data(20, canvas=96, seed=2)


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in ("derm", "derm_hw", "clinic", "clinic_hw"):
            a = getattr(g, f)
            assert a.is_cuda and torch.equal(
                a.cpu(), torch.from_numpy(getattr(w, f))), f
        assert np.array_equal(g.index, w.index)
        assert np.array_equal(g.mask, w.mask)
        assert np.array_equal(g.label, w.label)


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_under_a_side_stream_equals_host_batches(card, paired,
                                                          depth):
    """Two epochs, the wrap-padded last batch included, with work queued
    on the consumer's stream between the batches."""
    import threading

    from sm3x_torch.data.prefetch import PrefetchData

    feed = PrefetchData(paired, card, depth=depth)
    busy = torch.randn(2048, 2048, device=card)
    for epoch in (0, 1):
        got = []
        for b in feed.batches(8, epoch, 5):
            busy = busy @ busy.T * 1e-4      # keep the device at work
            got.append(b)
        _same_batches(got, paired.batches(8, epoch, 5))
    assert len(feed._ring.slots) == depth + 1
    assert all(s["bufs"][0].is_pinned() for s in feed._ring.slots if s)
    it = feed.batches(8, 0, 5)
    next(it)
    it.close()
    assert not [t for t in threading.enumerate()
                if t.name == "sm3x-torch-prefetch" and t.is_alive()]


def test_resident_feed_equals_host_batches(card, paired):
    from sm3x_torch.data.device_data import DeviceData
    from sm3x_torch.data.prefetch import resident_nbytes, wrap_for_device

    feed = wrap_for_device(paired, card)
    assert isinstance(feed, DeviceData)
    assert resident_nbytes(feed) == 20 * 2 * 96 * 96 * 3
    for epoch, shuffle in ((0, True), (1, True), (0, False)):
        _same_batches(feed.batches(8, epoch, 5, shuffle),
                      paired.batches(8, epoch, 5, shuffle))


def test_async_save_on_the_card_writes_the_snapshot(card, tmp_path):
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.train import common
    from sm3x_torch.train.backbone_train import SSLTrainer

    cfg = SSLConfig()
    cfg.model.arch, cfg.model.proj_dim = "resnet18", 16
    cfg.data.img_sz = (64, 64)
    cfg.optim.batch_size, cfg.optim.amp = 8, False
    cfg.run.device, cfg.run.log_path, cfg.run.world_size = "cuda", str(
        tmp_path), 2
    trainer = SSLTrainer(cfg)
    data = SyntheticPairedData(8, canvas=96, seed=0)
    batch = next(data.batches(8))
    args = [trainer._upload(x) for x in (batch.derm, batch.derm_hw,
                                         batch.clinic, batch.clinic_hw)]
    trainer.train_step(*args, 1)
    want = common.map_tensors(lambda t: t.detach().cpu().clone(),
                              trainer.live_state(0))
    path = str(tmp_path / "ckp_0.pth")
    trainer.save_async(path, 0)
    for it in (2, 3):
        trainer.train_step(*args, it)
    trainer.finish_checkpoints()
    got = torch.load(path, map_location="cpu", weights_only=True)
    a, b = [], []
    common.map_tensors(a.append, got)
    common.map_tensors(b.append, want)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    live = []
    common.map_tensors(live.append, trainer.state_dict(0))
    assert any(not torch.equal(x, y) for x, y in zip(a, live))
