"""The shape plans of the port's kernels K1 (sm3x_torch.ops.augment_cuda.
photometric_plan) and K2f (sm3x_torch.ops.ntxent_cuda.ntxent_forward_plan),
on the CPU: which kernel a shape takes, how many blocks, how many rows a
block holds, how much shared memory, all under the H100's 227 KB a block.

The kernels themselves run only on the card (tests/test_torch_kernels_cuda.
py); what surrounds them is Python, and is held here. `_banded` repeats
K1's decomposition in torch (bands with reflected halo rows, pointwise
rounds with one mean for the whole image, the blur inside a band) and is
held against `photometric_plain`, so the plan's geometry is checked against
the function the kernel must compute.
"""

from itertools import permutations

import numpy as np
import pytest
import torch

from sm3x_torch.ops import _native
from sm3x_torch.ops import augment as A
from sm3x_torch.ops import augment_cuda as K1
from sm3x_torch.ops import ntxent_cuda as K2

torch.set_num_threads(2)

MEAN, STD = (0.5, 0.45, 0.4), (0.25, 0.3, 0.2)

# (H, W, kernel): the stage-1 shape; fewer rows than a band; W no multiple
# of 4; bands of unequal height; the largest square that fits; too large a
# band; a row of more items than a block has threads
K1_SHAPES = [(224, 224, "band"), (2, 2, "band"), (5, 36, "band"),
             (31, 17, "band"), (35, 36, "band"), (64, 48, "band"),
             (448, 448, "band"), (640, 640, "scratch"),
             (30, 2052, "scratch"), (30, 513, "scratch")]


@pytest.mark.parametrize("h,w,kernel", K1_SHAPES)
def test_photometric_plan(h, w, kernel):
    plan = K1.photometric_plan(h, w)
    assert plan["kernel"] == kernel
    if kernel == "scratch":
        assert plan == dict(kernel="scratch", blocks=1, band_rows=h, px=1,
                            threads=1024, smem_bytes=0)
        return
    blocks, band = plan["blocks"], plan["band_rows"]
    assert 1 <= blocks <= K1.MAX_CLUSTER
    # the bands cover every row, and no block is left without one
    assert blocks * band >= h > (blocks - 1) * band
    assert band <= max(K1.BAND_ROWS, -(-h // K1.MAX_CLUSTER))
    assert plan["px"] == (4 if w % 4 == 0 else 1)
    assert plan["threads"] % 32 == 0 and w // plan["px"] <= plan["threads"]
    assert plan["smem_bytes"] == (band + 2) * 3 * w * 4
    assert plan["smem_bytes"] + 128 <= _native.SHARED_MEMORY_BYTES == 232448


def test_photometric_plan_stage1_shape():
    """224 x 224: 14 blocks of 16 + 2 rows, 48 KB, 16-byte accesses."""
    assert K1.photometric_plan(224, 224) == dict(
        kernel="band", blocks=14, band_rows=16, px=4, threads=256,
        smem_bytes=18 * 224 * 12)


def test_photometric_plan_unaligned_and_invalid():
    assert K1.photometric_plan(224, 224, aligned=False)["px"] == 1
    assert K1.photometric_plan(64, 48, aligned=False)["kernel"] == "band"
    for h, w in ((1, 8), (8, 1), (0, 0)):
        with pytest.raises(ValueError):
            K1.photometric_plan(h, w)


def _mixed_params(b, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = K1.build_params(gen, b, A.SSL_AUG, "cpu")
    orders = list(permutations(range(4)))
    for i in range(b):
        params[i, K1.P_ORD0:K1.P_ORD0 + 4] = torch.tensor(
            orders[(5 * i) % 24], dtype=torch.float32)
        for bit, col in enumerate((K1.P_DO_JIT, K1.P_DO_GRAY, K1.P_DO_FLIP,
                                   K1.P_DO_BLUR)):
            params[i, col] = float((i >> bit) & 1)
    return params


def _banded(images, params, mean, std, blocks, band):
    """K1's band kernel in torch: each block takes rows y0 .. y1 with the
    row above and below (reflected at the image's edges), applies the
    jitter rounds pointwise with the whole image's mean gray at the
    contrast round, then gray, blur inside the band, normalise and flip."""
    b, h, w, _ = images.shape
    col = lambda k: params[:, k, None, None, None]
    ops = (lambda t, m: A.adjust_brightness(t, col(K1.P_FB)),
           lambda t, m: torch.clamp(t * col(K1.P_FC)
                                    + (1 - col(K1.P_FC)) * m, 0, 1),
           lambda t, m: A.adjust_saturation(t, col(K1.P_FS)),
           lambda t, m: A.adjust_hue(t, col(K1.P_FH)))
    bands, rows = [], []
    for rank in range(blocks):
        y0, y1 = min(rank * band, h), min(rank * band + band, h)
        if y1 > y0:
            idx = ([1 if y0 == 0 else y0 - 1] + list(range(y0, y1))
                   + [h - 2 if y1 == h else y1])
            bands.append(images[:, idx])
            rows.append((y0, y1))
    jit = list(bands)
    for t in range(4):
        op = col(K1.P_ORD0 + t).long()
        # the mean gray of the whole image as it stands: own rows only
        mean_gray = sum(A.gray(x[:, 1:-1]).sum((1, 2)) for x in jit) / (h * w)
        m = mean_gray[:, None, None, None]
        for k, x in enumerate(jit):
            outs = [f(x, m) for f in ops]
            jit[k] = torch.where(op == 0, outs[0], torch.where(
                op == 1, outs[1], torch.where(op == 2, outs[2], outs[3])))
    out = torch.empty_like(images)
    for x0, x, (y0, y1) in zip(bands, jit, rows):
        x = torch.where(col(K1.P_DO_JIT) > 0.5, x, x0)
        x = torch.where(col(K1.P_DO_GRAY) > 0.5,
                        A.gray(x)[..., None].expand_as(x), x)
        # the blur's vertical reflect padding would mirror the halo rows:
        # only the band's own rows are kept, and they never read it
        blurred = A.gaussian_blur3(x, params[:, K1.P_SIGMA])
        x = torch.where(col(K1.P_DO_BLUR) > 0.5, blurred, x)[:, 1:-1]
        x = torch.where(col(K1.P_DO_FLIP) > 0.5, x.flip(2), x)
        out[:, y0:y1] = A.normalize_images(x, mean, std)
    return out


@pytest.mark.parametrize("h,w", [(hw[0], hw[1]) for hw in K1_SHAPES
                                 if hw[2] == "band" and hw[0] <= 64])
def test_band_decomposition_is_the_plain_chain(h, w):
    rng = np.random.default_rng(h * w)
    images = torch.from_numpy(rng.random((16, h, w, 3), dtype=np.float32))
    params = _mixed_params(16, seed=h)
    plan = K1.photometric_plan(h, w)
    got = _banded(images, params, MEAN, STD, plan["blocks"],
                  plan["band_rows"])
    want = K1.photometric_plain(images, params, MEAN, STD)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_band_decomposition_with_idle_blocks():
    """More blocks than rows: the blocks past the last row hold nothing."""
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.random((16, 5, 8, 3), dtype=np.float32))
    params = _mixed_params(16, seed=1)
    got = _banded(images, params, MEAN, STD, blocks=8, band=1)
    want = K1.photometric_plain(images, params, MEAN, STD)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


# (n, D): the stage-1 problem; the smallest; D no multiple of 4; the widest
# D; many rows; a D whose 16-byte steps are odd; a problem that streams tiles
K2_SHAPES = [(96, 128), (2, 1), (10, 33), (64, 512), (300, 64), (10, 28),
             (4096, 512)]


@pytest.mark.parametrize("n,d", K2_SHAPES)
def test_ntxent_forward_plan(n, d):
    plan = K2.ntxent_forward_plan(n, d)
    stride, tile = plan["stride"], plan["tile_rows"]
    # rows are whole 16-byte steps with at least one step of padding, an odd
    # number of them: eight rows in a column start in eight distinct groups
    # of four banks
    assert stride % 4 == 0 and stride >= (d + 3) // 4 * 4 + 4
    assert stride <= (d + 3) // 4 * 4 + 8 and (stride // 4) % 2 == 1
    assert len({(r * stride // 4) % 8 for r in range(8)}) == 8
    assert plan["chunk_rows"] == K2.CHUNK_ROWS == 12
    assert plan["rows_per_block"] * K2.CLUSTER >= n
    assert (plan["rows_per_block"] - 1) * K2.CLUSTER < n
    assert tile % K2.COLUMN_BLOCK == 0 and tile >= K2.COLUMN_BLOCK
    assert plan["tiles"] * tile >= n > (plan["tiles"] - 1) * tile
    assert plan["smem_bytes"] == (12 + tile) * (stride + 1) * 4
    assert plan["smem_bytes"] + 128 <= _native.SHARED_MEMORY_BYTES
    assert plan["vec"] == (d % 4 == 0)
    # a larger tile would not fit, or is not needed
    more = (12 + tile + K2.COLUMN_BLOCK) * (stride + 1) * 4 + 128
    assert tile >= n or more > _native.SHARED_MEMORY_BYTES


def test_ntxent_forward_plan_stage1_shape():
    """(96, 128): 12 rows a block, the whole problem one tile of 57 KB."""
    assert K2.ntxent_forward_plan(96, 128) == dict(
        rows_per_block=12, chunk_rows=12, stride=132, tile_rows=96, tiles=1,
        smem_bytes=108 * 133 * 4, vec=True)
    assert not K2.ntxent_forward_plan(96, 128, aligned=False)["vec"]
