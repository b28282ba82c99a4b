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


@pytest.mark.parametrize("s", [1, 63, 64, 65, 197, 257])
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
