"""The SSL view, plain PyTorch: a frozen copy of the recipe's augmentation.

    uint8 canvas (B, S, S, 3) -> RandomResizedCrop (torchvision's
    get_params over 10 attempts, antialiased bilinear resize as two
    products) -> ColorJitter in a per-image order @ 0.8 -> grayscale @ 0.2
    -> horizontal flip @ 0.5 -> 3x3 Gaussian blur @ 0.5 -> normalise.

Each view draws from its own generator in a fixed order (the crop boxes,
then the per-image parameters), with the distributions the recipe states,
so that the same seed gives the same view as the program's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Aug:
    out_size: Tuple[int, int] = (224, 224)
    rrc_scale: Tuple[float, float] = (0.5, 1.0)
    rrc_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    jitter_p: float = 0.8
    jitter: Tuple[float, float, float, float] = (0.8, 0.8, 0.8, 0.2)
    grayscale_p: float = 0.2
    flip_p: float = 0.5
    blur_p: float = 0.5
    blur_sigma: Tuple[float, float] = (0.1, 2.0)


def _uniform(gen, shape, low, high, device):
    return low + (high - low) * torch.rand(shape, generator=gen, device=device)


def crop_boxes(gen, h, w, aug: Aug):
    """(y0, x0, ch, cw) a image: the first of 10 (scale, log-ratio) draws
    that fits, else a centre crop at the clamped aspect."""
    n, dev = h.shape[0], h.device
    lo, hi = aug.rrc_ratio
    scales = _uniform(gen, (n, 10), aug.rrc_scale[0], aug.rrc_scale[1], dev)
    ratios = torch.exp(_uniform(gen, (n, 10), math.log(lo), math.log(hi), dev))
    target = (h * w)[:, None] * scales
    cw = torch.round(torch.sqrt(target * ratios))
    ch = torch.round(torch.sqrt(target / ratios))
    ok = (cw > 0) & (cw <= w[:, None]) & (ch > 0) & (ch <= h[:, None])
    first = torch.argmax(ok.to(torch.int32), dim=1, keepdim=True)
    any_ok = ok.any(dim=1)
    fw = torch.where(w / h > hi, torch.round(h * hi), w)
    fh = torch.where(w / h < lo, torch.round(w / lo), h)
    ch = torch.where(any_ok, ch.gather(1, first)[:, 0], fh)
    cw = torch.where(any_ok, cw.gather(1, first)[:, 0], fw)
    u_i = torch.rand(n, generator=gen, device=dev)
    u_j = torch.rand(n, generator=gen, device=dev)
    y0 = torch.where(any_ok, torch.floor(u_i * (h - ch + 1.0)),
                     torch.round((h - ch) / 2.0))
    x0 = torch.where(any_ok, torch.floor(u_j * (w - cw + 1.0)),
                     torch.round((w - cw) / 2.0))
    return y0, x0, ch, cw


def _weights(n_in, n_out, start, size):
    """(B, n_out, n_in) antialiased bilinear weights of one axis, confined
    to the crop window and renormalised."""
    dev = start.device
    start, size = start[:, None, None], size[:, None, None]
    scale = size / n_out
    support = torch.clamp(scale, min=1.0)
    o = torch.arange(n_out, device=dev, dtype=torch.float32)[None, :, None]
    i = torch.arange(n_in, device=dev, dtype=torch.float32)[None, None, :]
    src = start + (o + 0.5) * scale - 0.5
    wgt = torch.clamp(1.0 - torch.abs(i - src) / support, min=0.0)
    inside = (i >= start - 0.5) & (i <= start + size - 0.5)
    wgt = torch.where(inside, wgt, torch.zeros_like(wgt))
    return wgt / torch.clamp(wgt.sum(dim=2, keepdim=True), min=1e-8)


def crop_resize(canvases, valid_hw, gen, aug: Aug):
    img = canvases.float() / 255.0
    b, h, w, c = img.shape
    oh, ow = aug.out_size
    y0, x0, ch, cw = crop_boxes(gen, valid_hw[:, 0].float(),
                                valid_hw[:, 1].float(), aug)
    wy, wx = _weights(h, oh, y0, ch), _weights(w, ow, x0, cw)
    tmp = torch.bmm(wy, img.reshape(b, h, w * c))
    tmp = tmp.view(b, oh, w, c).transpose(1, 2).reshape(b, w, oh * c)
    out = torch.bmm(wx, tmp).view(b, ow, oh, c).transpose(1, 2)
    return torch.clamp(out, 0.0, 1.0)


def draw_params(gen, n, aug: Aug, device):
    """Per image: the four jitter factors, the jitter order, the four
    coin flips (jitter, grayscale, flip, blur) and the blur's sigma."""
    bj, cj, sj, hj = aug.jitter

    def u(low=0.0, high=1.0):
        return _uniform(gen, (n,), low, high, device)

    factors = [u(max(0.0, 1 - bj), 1 + bj), u(max(0.0, 1 - cj), 1 + cj),
               u(max(0.0, 1 - sj), 1 + sj), u(-hj, hj)]
    order = torch.argsort(torch.rand((n, 4), generator=gen, device=device),
                          dim=1)
    coins = [u() < p for p in (aug.jitter_p, aug.grayscale_p, aug.flip_p,
                               aug.blur_p)]
    return factors, order, coins, u(*aug.blur_sigma)


def _gray(x):
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _brightness(x, f):
    return torch.clamp(x * f, 0.0, 1.0)


def _contrast(x, f):
    mean = _gray(x).mean(dim=(1, 2))[:, None, None, None]
    return torch.clamp(x * f + (1.0 - f) * mean, 0.0, 1.0)


def _saturation(x, f):
    return torch.clamp(x * f + (1.0 - f) * _gray(x)[..., None], 0.0, 1.0)


def _hue(x, f):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(delta == 0.0, torch.ones_like(delta), delta)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(torch.where(delta == 0.0, torch.zeros_like(h),
                                    h / 6.0), 1.0)
    s = torch.where(maxc == 0.0, torch.zeros_like(delta),
                    delta / torch.where(maxc == 0.0, torch.ones_like(maxc),
                                        maxc))
    h = torch.remainder(h + f[..., 0], 1.0)

    def comp(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return maxc - maxc * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0,
                                             1.0)

    return torch.stack([comp(5.0), comp(3.0), comp(1.0)], dim=-1)


def _blur(x, sigma):
    side = torch.exp(-0.5 / torch.clamp(sigma * sigma, min=1e-8))
    w0 = (1.0 / (1.0 + 2.0 * side))[:, None, None, None]
    w1 = (side / (1.0 + 2.0 * side))[:, None, None, None]
    h, w = x.shape[1], x.shape[2]
    dev = x.device
    up = torch.tensor([1] + list(range(h - 1)), device=dev)
    dn = torch.tensor(list(range(1, h)) + [h - 2], device=dev)
    x = w0 * x + w1 * (x[:, up] + x[:, dn])
    lf = torch.tensor([1] + list(range(w - 1)), device=dev)
    rt = torch.tensor(list(range(1, w)) + [w - 2], device=dev)
    return w0 * x + w1 * (x[:, :, lf] + x[:, :, rt])


def photometric(x, params, mean, std):
    factors, order, coins, sigma = params
    col = [f[:, None, None, None] for f in factors]
    ops = (_brightness, _contrast, _saturation, _hue)
    jit = x
    for t in range(4):
        pick = order[:, t][:, None, None, None]
        outs = [op(jit, c) for op, c in zip(ops, col)]
        jit = torch.where(pick == 0, outs[0], torch.where(
            pick == 1, outs[1], torch.where(pick == 2, outs[2], outs[3])))
    on = [c[:, None, None, None] for c in coins]
    x = torch.where(on[0], jit, x)
    x = torch.where(on[1], _gray(x)[..., None].expand_as(x), x)
    x = torch.where(on[2], x.flip(2), x)
    x = torch.where(on[3], _blur(x, sigma), x)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def view(seed: int, canvases, valid_hw, mean, std, aug: Aug):
    """One augmented view a canvas, (B, oh, ow, 3) float32, from the
    generator of `seed` on the canvases' device."""
    from portbench.reference.prng import generator

    gen = generator(seed, canvases.device)
    x = crop_resize(canvases, valid_hw, gen, aug)
    return photometric(x, draw_params(gen, x.shape[0], aug, x.device),
                       mean, std)
