"""Photometric augmentation kernel K1 (sm3x_torch/csrc/photometric.cu), its
plain PyTorch twin, the per-image parameter matrix, the shape plan that
picks one of K1's two kernels, and the SSL view pipeline built on them.

Counterpart of sm3x/ops/augment_pallas.py (`photometric_pallas` :162,
`ssl_augment_batch_fused` :192, `build_params` :223). The (B, 16) parameter
layout is the same, so one matrix drives the kernel, the twin and, in the
tests, the Pallas kernel.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
Which of the two kernels a CUDA tensor takes follows from its shape (and
its alignment) alone, by `photometric_plan`; `photometric_cuda.variants`
counts the launches of each.
"""

from __future__ import annotations

import torch

from sm3x_torch.ops import _native
from sm3x_torch.ops import augment as A

# params vector layout (per image)
P_FB, P_FC, P_FS, P_FH = 0, 1, 2, 3          # jitter factors
P_ORD0 = 4                                   # op order in columns 4..7
P_DO_JIT, P_DO_GRAY, P_DO_FLIP, P_DO_BLUR = 8, 9, 10, 11
P_SIGMA = 12
P_SIZE = 16

# The band kernel's shape (csrc/photometric.cu). 16 rows and two halo rows of
# 224 pixels are 48 KB, four blocks an SM: tools/k1_variants_torch.py is the
# sweep over blocks an image and threads a block that these came from.
MAX_CLUSTER = 16     # blocks an image, at most
BAND_ROWS = 16       # rows a block aims at
BAND_THREADS = 256   # threads of one block
_BAND_STATIC = 128   # bytes of static shared memory the kernel declares


def photometric_plan(h: int, w: int, aligned: bool = True) -> dict:
    """How K1 runs an (H, W, 3) image, from the shape alone. The band
    kernel gives each block of a cluster a band of rows and keeps it, with
    two halo rows, in shared memory: ceil(H / BAND_ROWS) blocks an image, at
    most MAX_CLUSTER, of ceil(H / blocks) rows each. A band that does not
    fit, or a row of more items than a block has threads, takes the scratch
    kernel, one block an image over a scratch copy in device memory. `px`
    is the pixels a thread moves at a time: 4 (16-byte accesses) where W is
    a multiple of 4 and the tensors are 16-byte aligned, else 1."""
    if h < 2 or w < 2:
        raise ValueError(f"need H >= 2 and W >= 2, got {h} x {w}")
    px = 4 if w % 4 == 0 and aligned else 1
    blocks = min(MAX_CLUSTER, -(-h // BAND_ROWS))
    band = -(-h // blocks)
    smem = (band + 2) * 3 * w * 4
    # the last pass takes a row's items (W / px) from one thread each
    if (smem + _BAND_STATIC > _native.SHARED_MEMORY_BYTES
            or w // px > BAND_THREADS):
        return dict(kernel="scratch", blocks=1, band_rows=h, px=1,
                    threads=1024, smem_bytes=0)
    return dict(kernel="band", blocks=blocks, band_rows=band, px=px,
                threads=BAND_THREADS, smem_bytes=smem)


def build_params(gen: torch.Generator, batch: int, cfg: A.AugConfig,
                 device, rows=None) -> torch.Tensor:
    """Sample the (B, 16) per-image parameter matrix with the XLA chain's
    distributions (augment_pallas.py:223-245); with `rows`, drawn for the
    global batch and cut to them (`augment.batch_draws`)."""
    bj, cj, sj, hj = cfg.jitter
    n, cut = A.batch_draws(batch, rows)

    def u(low=0.0, high=1.0):
        return cut(A.uniform(gen, (n,), low, high, device))

    cols = [u(max(0.0, 1 - bj), 1 + bj), u(max(0.0, 1 - cj), 1 + cj),
            u(max(0.0, 1 - sj), 1 + sj), u(-hj, hj)]
    order = torch.argsort(cut(torch.rand((n, 4), generator=gen,
                                         device=device)), dim=1)
    cols += [order[:, i].float() for i in range(4)]
    for p in (cfg.jitter_p, cfg.grayscale_p, cfg.flip_p, cfg.blur_p):
        cols.append((u() < p).float())
    cols.append(u(*cfg.blur_sigma))
    params = torch.zeros((batch, P_SIZE), dtype=torch.float32, device=device)
    params[:, :len(cols)] = torch.stack(cols, dim=1)
    return params


def _col(params: torch.Tensor, k: int) -> torch.Tensor:
    return params[:, k, None, None, None]


def photometric_plain(images: torch.Tensor, params: torch.Tensor, mean,
                      std) -> torch.Tensor:
    """The chain K1 computes, in torch: per-image jitter rounds in the
    image's op order (each round computes all four ops for the batch and
    selects), then grayscale, flip, blur and normalise."""
    x = images
    ops = (lambda t: A.adjust_brightness(t, _col(params, P_FB)),
           lambda t: A.adjust_contrast(t, _col(params, P_FC)),
           lambda t: A.adjust_saturation(t, _col(params, P_FS)),
           lambda t: A.adjust_hue(t, _col(params, P_FH)))
    jit = x
    for t in range(4):
        op = _col(params, P_ORD0 + t).long()
        outs = [f(jit) for f in ops]
        jit = torch.where(op == 0, outs[0], torch.where(
            op == 1, outs[1], torch.where(op == 2, outs[2], outs[3])))
    x = torch.where(_col(params, P_DO_JIT) > 0.5, jit, x)
    x = torch.where(_col(params, P_DO_GRAY) > 0.5,
                    A.gray(x)[..., None].expand_as(x), x)
    x = torch.where(_col(params, P_DO_FLIP) > 0.5, x.flip(2), x)
    x = torch.where(_col(params, P_DO_BLUR) > 0.5,
                    A.gaussian_blur3(x, params[:, P_SIGMA]), x)
    return A.normalize_images(x, mean, std)


def photometric_cuda(images: torch.Tensor, params: torch.Tensor, mean,
                     std) -> torch.Tensor:
    """K1: images (B, H, W, 3) f32 in [0, 1] and params (B, 16) f32, both
    contiguous on one CUDA device -> normalised (B, H, W, 3) f32."""
    if not (images.is_cuda and params.is_cuda
            and images.device == params.device):
        raise ValueError("photometric_cuda takes CUDA tensors on one device")
    if (images.dtype != torch.float32 or params.dtype != torch.float32
            or not images.is_contiguous() or not params.is_contiguous()):
        raise ValueError("images and params must be contiguous float32")
    b, h, w, c = images.shape
    if c != 3 or h < 2 or w < 2 or tuple(params.shape) != (b, P_SIZE):
        raise ValueError(f"need images (B, H>=2, W>=2, 3) and params "
                         f"(B, {P_SIZE}); got {tuple(images.shape)}, "
                         f"{tuple(params.shape)}")
    out = torch.empty_like(images)
    plan = photometric_plan(h, w, aligned=(images.data_ptr() % 16 == 0
                                           and out.data_ptr() % 16 == 0))
    lib = _native.library()
    norm = [float(m) for m in mean] + [float(s) for s in std]
    stream = _native.stream_handle(images.device)
    photometric_cuda.launches += 1
    photometric_cuda.variants[plan["kernel"]] += 1
    if plan["kernel"] == "band":
        _native.check(lib.sm3x_photometric_band(
            images.data_ptr(), params.data_ptr(), out.data_ptr(), b, h, w,
            plan["blocks"], plan["band_rows"], plan["px"], plan["threads"],
            *norm, stream),
            "sm3x_photometric_band")
    else:
        scratch = torch.empty_like(images)
        _native.check(lib.sm3x_photometric_scratch(
            images.data_ptr(), params.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), b, h, w, *norm, stream),
            "sm3x_photometric_scratch")
    return out


photometric_cuda.launches = 0
photometric_cuda.variants = {"band": 0, "scratch": 0}  # launches by kernel


def photometric(images: torch.Tensor, params: torch.Tensor, mean,
                std) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain twin on a CPU tensor."""
    if images.is_cuda:
        return photometric_cuda(images, params, mean, std)
    return photometric_plain(images, params, mean, std)


def ssl_augment_batch_fused(gen: torch.Generator, canvases: torch.Tensor,
                            valid_hw: torch.Tensor, mean, std,
                            cfg: A.AugConfig = A.SSL_AUG,
                            rows=None) -> torch.Tensor:
    """One augmented view per canvas: RRC crop-resize (torch.bmm), then the
    photometric chain under one (B, 16) parameter matrix. `gen` lives on the
    canvases' device and is drawn from in a fixed order (boxes, then
    parameters), for the global batch where `rows` are given."""
    x = A.batch_crop_resize(gen, canvases, valid_hw, cfg, rows)
    params = build_params(gen, x.shape[0], cfg, x.device, rows)
    return photometric(x, params, mean, std)
