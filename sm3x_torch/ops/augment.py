"""On-device image augmentation, plain PyTorch (counterpart of the SSL part
of sm3x/ops/augment.py).

    uint8 canvas (B, S, S, 3)
      -> RandomResizedCrop  (per-image boxes, bilinear resize as two bmm)
      -> ColorJitter        (per-image factors and op order) @ p
      -> RandomGrayscale -> RandomHorizontalFlip -> GaussianBlur 3x3 @ p
      -> Normalize          -> (B, oh, ow, 3) float32, NHWC

The geometry stays plain torch (`torch.bmm`), as the JAX package left it to
XLA. The photometric ops below are the pieces of the plain twin of kernel
K1 (`sm3x_torch.ops.augment_cuda.photometric_plain`); on a CUDA tensor the
pipeline runs K1 instead. Their formulas are the Pallas kernel's
(sm3x/ops/augment_pallas.py:37-159), which the XLA chain agrees with.

Randomness comes from an explicit `torch.Generator` on the images' device.
Its numbers differ from `jax.random`'s; the distributions are the same.
With `rows` (sm3x_torch.core.mesh.Rows: this process's rows of a global
batch) every random tensor is drawn at the global batch's shape and cut to
the rows, so each image gets the parameters it gets on one process.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AugConfig:
    out_size: Tuple[int, int] = (224, 224)
    # RandomResizedCrop
    rrc: bool = True
    rrc_scale: Tuple[float, float] = (0.5, 1.0)
    rrc_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    # ColorJitter(brightness, contrast, saturation, hue) @ p
    jitter_p: float = 0.8
    jitter: Tuple[float, float, float, float] = (0.8, 0.8, 0.8, 0.2)
    grayscale_p: float = 0.2
    flip_p: float = 0.5
    # GaussianBlur 3x3, sigma ~ U[lo, hi] @ p
    blur_p: float = 0.5
    blur_sigma: Tuple[float, float] = (0.1, 2.0)
    antialias: bool = True


# The reference's SSL recipe
SSL_AUG = AugConfig()
MLC_TRAIN_AUG = AugConfig(jitter_p=0.5, grayscale_p=0.0, blur_p=0.0)
FINETUNE_AUG = AugConfig(rrc_scale=(0.3, 1.0), jitter_p=0.0, grayscale_p=0.0,
                         blur_p=0.0)
PROBE_AUG = AugConfig(jitter_p=0.0, grayscale_p=0.0, blur_p=0.0)


def uniform(gen: torch.Generator, shape, low: float, high: float,
            device) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=gen,
                                           device=device)


def batch_draws(batch: int, rows=None):
    """(rows to draw, cut): a batch of `batch` images draws for the whole
    global batch of `rows` and keeps its own rows; without `rows` it draws
    for itself."""
    if rows is None:
        return batch, lambda t: t
    if rows.size != batch:
        raise ValueError(f"{batch} images, but rows {rows.start}:{rows.stop}")
    return rows.total, rows.take


# ----------------------------------------------------------------------------
# RandomResizedCrop
# ----------------------------------------------------------------------------

def sample_rrc_boxes(gen: torch.Generator, h: torch.Tensor, w: torch.Tensor,
                     cfg: AugConfig, rows=None):
    """torchvision RandomResizedCrop.get_params, vectorised over the batch
    (sm3x/ops/augment.py:70-111): 10 attempts over (area scale, log aspect);
    the first that fits wins; otherwise a centre crop at the clamped aspect.
    h, w: (B,) float valid sizes. Returns (y0, x0, ch, cw), each (B,)."""
    n, cut = batch_draws(h.shape[0], rows)
    dev = h.device
    area = (h * w)[:, None]
    lo, hi = cfg.rrc_ratio
    scales = cut(uniform(gen, (n, 10), cfg.rrc_scale[0], cfg.rrc_scale[1],
                         dev))
    ratios = torch.exp(cut(uniform(gen, (n, 10), math.log(lo), math.log(hi),
                                   dev)))
    target = area * scales
    cw = torch.round(torch.sqrt(target * ratios))
    ch = torch.round(torch.sqrt(target / ratios))
    ok = (cw > 0) & (cw <= w[:, None]) & (ch > 0) & (ch <= h[:, None])
    first = torch.argmax(ok.to(torch.int32), dim=1, keepdim=True)
    any_ok = ok.any(dim=1)

    in_ratio = w / h
    fw = torch.where(in_ratio > hi, torch.round(h * hi), w)
    fh = torch.where(in_ratio < lo, torch.round(w / lo), h)
    ch_sel = torch.where(any_ok, ch.gather(1, first)[:, 0], fh)
    cw_sel = torch.where(any_ok, cw.gather(1, first)[:, 0], fw)

    u_i = cut(torch.rand(n, generator=gen, device=dev))
    u_j = cut(torch.rand(n, generator=gen, device=dev))
    y0 = torch.where(any_ok, torch.floor(u_i * (h - ch_sel + 1.0)),
                     torch.round((h - ch_sel) / 2.0))
    x0 = torch.where(any_ok, torch.floor(u_j * (w - cw_sel + 1.0)),
                     torch.round((w - cw_sel) / 2.0))
    return y0, x0, ch_sel, cw_sel


def _resample_matrix(n_in: int, n_out: int, crop_start: torch.Tensor,
                     crop_size: torch.Tensor, antialias: bool) -> torch.Tensor:
    """(B, n_out, n_in) bilinear weights for one axis (augment.py:114-139):
    output o samples crop_start + (o + 0.5) * crop_size / n_out - 0.5 with a
    triangle filter widened by the downscale factor when antialiasing. The
    filter is confined to the crop window and each row renormalised, the
    clamp-to-edge semantics of resizing a pre-cropped image."""
    dev = crop_start.device
    start = crop_start.float()[:, None, None]
    size = crop_size.float()[:, None, None]
    scale = size / n_out
    support = torch.clamp(scale, min=1.0) if antialias else torch.ones_like(
        scale)
    o = torch.arange(n_out, device=dev, dtype=torch.float32)[None, :, None]
    i = torch.arange(n_in, device=dev, dtype=torch.float32)[None, None, :]
    src = start + (o + 0.5) * scale - 0.5
    wgt = torch.clamp(1.0 - torch.abs(i - src) / support, min=0.0)
    inside = (i >= start - 0.5) & (i <= start + size - 0.5)
    wgt = torch.where(inside, wgt, torch.zeros_like(wgt))
    return wgt / torch.clamp(wgt.sum(dim=2, keepdim=True), min=1e-8)


def crop_resize(img: torch.Tensor, y0, x0, ch, cw, out_size,
                antialias: bool = True) -> torch.Tensor:
    """Resize each image's [y0:y0+ch, x0:x0+cw) window to out_size.
    img (B, H, W, C) float -> (B, oh, ow, C): two batched matmuls."""
    b, h, w, c = img.shape
    oh, ow = out_size
    wy = _resample_matrix(h, oh, y0, ch, antialias)            # (B, oh, H)
    wx = _resample_matrix(w, ow, x0, cw, antialias)            # (B, ow, W)
    tmp = torch.bmm(wy, img.reshape(b, h, w * c))              # (B, oh, W*C)
    tmp = tmp.view(b, oh, w, c).transpose(1, 2).reshape(b, w, oh * c)
    out = torch.bmm(wx, tmp).view(b, ow, oh, c)                # (B, ow, oh, C)
    return out.transpose(1, 2).contiguous()


def batch_crop_resize(gen: torch.Generator, canvases: torch.Tensor,
                      valid_hw: torch.Tensor, cfg: AugConfig,
                      rows=None) -> torch.Tensor:
    """uint8 canvases (B, S, S, 3) + valid (B, 2) -> RRC views in [0, 1]."""
    img = canvases.float() / 255.0
    h = valid_hw[:, 0].float()
    w = valid_hw[:, 1].float()
    if cfg.rrc:
        y0, x0, ch, cw = sample_rrc_boxes(gen, h, w, cfg, rows)
    else:
        y0, x0, ch, cw = torch.zeros_like(h), torch.zeros_like(w), h, w
    out = crop_resize(img, y0, x0, ch, cw, cfg.out_size, cfg.antialias)
    return torch.clamp(out, 0.0, 1.0)


# ----------------------------------------------------------------------------
# Photometric ops on (B, H, W, 3) floats in [0, 1]; factors are (B, 1, 1, 1)
# ----------------------------------------------------------------------------

def gray(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 luma, (B, H, W)."""
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def adjust_brightness(x, f):
    return torch.clamp(x * f, 0.0, 1.0)


def adjust_contrast(x, f):
    mean = gray(x).mean(dim=(1, 2))[:, None, None, None]
    return torch.clamp(x * f + (1.0 - f) * mean, 0.0, 1.0)


def adjust_saturation(x, f):
    return torch.clamp(x * f + (1.0 - f) * gray(x)[..., None], 0.0, 1.0)


def adjust_hue(x, f):
    """HSV hue rotation h += f (mod 1), rebuilt with the k-offset formula."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(delta == 0.0, torch.ones_like(delta), delta)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(torch.where(delta == 0.0, torch.zeros_like(h), h / 6.0),
                        1.0)
    s = torch.where(maxc == 0.0, torch.zeros_like(delta),
                    delta / torch.where(maxc == 0.0, torch.ones_like(maxc),
                                        maxc))
    v = maxc
    h = torch.remainder(h + f[..., 0], 1.0)

    def comp(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([comp(5.0), comp(3.0), comp(1.0)], dim=-1)


def blur_weights(sigma: torch.Tensor):
    """Centre and side taps of the 3-tap Gaussian, normalised:
    w1 = exp(-0.5 / max(sigma^2, 1e-8)) / (1 + 2 w1'). This is the Pallas
    kernel's form (augment_pallas.py:140-142); the XLA chain's
    exp(-0.5 (x / sigma)^2) is the same function at x = +-1."""
    side = torch.exp(-0.5 / torch.clamp(sigma * sigma, min=1e-8))
    norm = 1.0 + 2.0 * side
    return 1.0 / norm, side / norm


def gaussian_blur3(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """3x3 separable Gaussian with reflect padding and per-image sigma (B,):
    rows first, then columns."""
    w0, w1 = (t[:, None, None, None] for t in blur_weights(sigma))
    h, w = x.shape[1], x.shape[2]
    dev = x.device
    up = torch.tensor([1] + list(range(h - 1)), device=dev)
    dn = torch.tensor(list(range(1, h)) + [h - 2], device=dev)
    x = w0 * x + w1 * (x[:, up] + x[:, dn])
    lf = torch.tensor([1] + list(range(w - 1)), device=dev)
    rt = torch.tensor(list(range(1, w)) + [w - 2], device=dev)
    return w0 * x + w1 * (x[:, :, lf] + x[:, :, rt])


def normalize_images(img: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std on [0, 1] floats; NHWC."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=img.device)
    return (img - mean) / std


# ----------------------------------------------------------------------------
# Pipelines
# ----------------------------------------------------------------------------

def ssl_augment_batch(gen: torch.Generator, canvases: torch.Tensor,
                      valid_hw: torch.Tensor, mean, std,
                      cfg: AugConfig = SSL_AUG, rows=None) -> torch.Tensor:
    """One augmented view per canvas: (B, oh, ow, 3) f32, normalised. The
    photometric chain is kernel K1 on CUDA tensors and its plain twin on CPU
    tensors (see sm3x_torch.ops.augment_cuda.ssl_augment_batch_fused)."""
    from sm3x_torch.ops.augment_cuda import ssl_augment_batch_fused

    return ssl_augment_batch_fused(gen, canvases, valid_hw, mean, std, cfg,
                                   rows)


def supervised_augment_batch(gen: torch.Generator, canvases: torch.Tensor,
                             valid_hw: torch.Tensor, mean, std,
                             cfg: AugConfig = FINETUNE_AUG,
                             rows=None) -> torch.Tensor:
    """A supervised train view per canvas: the same pipeline under the
    finetune preset (crop, flip and normalise; K1 on CUDA tensors)."""
    return ssl_augment_batch(gen, canvases, valid_hw, mean, std, cfg, rows)


def modality_keys(kd: int, kc: int, joint_aug: bool = False):
    """Per-modality augmentation seeds (k_derm, k_clinic). joint_aug=True
    (SevenPCBaseDataset2) hands both modalities the derm seed, so the pair
    shares every random parameter."""
    return (kd, kd) if joint_aug else (kd, kc)


def modality_valid_hw(derm_hw, clinic_hw, joint_aug: bool = False):
    """Per-modality valid crop regions; under joint_aug both crop within the
    common (min h, min w) region."""
    if not joint_aug:
        return derm_hw, clinic_hw
    hw = torch.minimum(derm_hw, clinic_hw)
    return hw, hw


def multicrop_augment_batch(seed: int, canvases: torch.Tensor,
                            valid_hw: torch.Tensor, mean, std,
                            size_crops=(224, 96), nmb_crops=(2, 6),
                            min_scale_crops=(0.5, 0.14),
                            max_scale_crops=(1.0, 0.5),
                            base_cfg: AugConfig = SSL_AUG,
                            rows=None) -> list:
    """SwAV-style multi-crop (counterpart of sm3x/ops/augment.py:365):
    nmb_crops[i] views at size_crops[i] x size_crops[i] with RRC scales
    (min_scale_crops[i], max_scale_crops[i]); the views of all groups in
    order, globals (group 0) first. View `idx` draws from its own generator,
    `fold_in(seed, idx)`: it is cropped and draws its parameter rows as
    `ssl_augment_batch` does, and the rows of all views of one group go
    through K1 at once (K1 works image by image, so the numbers are those
    of one launch a view)."""
    from sm3x_torch.core import prng
    from sm3x_torch.ops.augment_cuda import build_params, photometric

    dev = canvases.device
    views, idx = [], 0
    for size, n, lo, hi in zip(size_crops, nmb_crops, min_scale_crops,
                               max_scale_crops):
        if not n:
            continue
        cfg = dataclasses.replace(base_cfg, out_size=(size, size),
                                  rrc_scale=(lo, hi))
        crops, params = [], []
        for v in range(n):
            g = prng.generator(prng.fold_in(seed, idx + v), dev)
            crops.append(batch_crop_resize(g, canvases, valid_hw, cfg, rows))
            params.append(build_params(g, crops[-1].shape[0], cfg, dev, rows))
        idx += n
        out = photometric(torch.cat(crops), torch.cat(params), mean, std)
        views += list(out.chunk(n))
    return views


def eval_resize_batch(canvases: torch.Tensor, valid_hw: torch.Tensor, mean,
                      std, out_size=(224, 224)) -> torch.Tensor:
    """Deterministic eval path: resize the valid region, then normalise."""
    h = valid_hw[:, 0].float()
    w = valid_hw[:, 1].float()
    zero = torch.zeros_like(h)
    out = crop_resize(canvases.float() / 255.0, zero, zero, h, w, out_size)
    return normalize_images(torch.clamp(out, 0.0, 1.0), mean, std)


def normalize_uint8(x, mean, std) -> torch.Tensor:
    """uint8 NHWC batch -> normalised float32: (x / 255 - mean) / std."""
    x = torch.as_tensor(x)
    return normalize_images(x.float() / 255.0, mean, std)


def denormalize_to_uint8(x: torch.Tensor, mean, std) -> torch.Tensor:
    """The inverse of `normalize_uint8`, clipped to [0, 255] and truncated
    to uint8."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return torch.clamp((x * std + mean) * 255.0, 0, 255).to(torch.uint8)
