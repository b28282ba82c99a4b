"""What the benchmark makes from `--seed` and hands to the program and to the
reference alike: the paired uint8 canvases of a split, and the weights.

The canvases are a frozen copy of the port's `synthetic_canvas_batch`
(random uint8 canvases, valid sizes uniform in [S/2, S], eight binary
labels): derm from the seed, clinic from the seed + 1. The weights are one
normal draw on the device from a generator of the seed, cut into the
leaves in the order of their names and scaled by the leaf's shape; a
vector named `*.weight` (a norm's scale) is 1 and any other vector 0.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from portbench.reference.prng import fold_in

WEIGHT_STREAM = 7


def canvas_batch(n: int, canvas: int, seed: int):
    """(canvases (n, S, S, 3) uint8, valid hw (n, 2) int32, labels (n, 8))."""
    rng = np.random.default_rng(seed)
    canvases = rng.integers(0, 256, (n, canvas, canvas, 3), dtype=np.uint8)
    hw = np.stack([rng.integers(canvas // 2, canvas + 1, n),
                   rng.integers(canvas // 2, canvas + 1, n)],
                  axis=1).astype(np.int32)
    labels = rng.integers(0, 2, (n, 8)).astype(np.int32)
    return canvases, hw, labels


def paired_split(n: int, canvas: int, seed: int) -> dict:
    derm, derm_hw, labels = canvas_batch(n, canvas, seed)
    clinic, clinic_hw, _ = canvas_batch(n, canvas, seed + 1)
    return dict(derm=derm, derm_hw=derm_hw, clinic=clinic,
                clinic_hw=clinic_hw, labels=labels)


def _std(shape) -> float:
    if shape[0] == 1:                      # class token, position embedding
        return 0.02
    fan_in = math.prod(shape[1:])
    return math.sqrt((2.0 if len(shape) == 4 else 1.0) / fan_in)


def make_weights(shapes: dict, seed: int, device, constants=None) -> dict:
    """{name: tensor} for {name: shape}, float32 on `device`. `constants`
    ({regular expression: value}) sets the vectors whose name matches to
    that value instead (the configuration's `init_constants`)."""
    names = sorted(shapes)
    constants = [(re.compile(p), v) for p, v in (constants or {}).items()]
    mats = [n for n in names if len(shapes[n]) >= 2]
    total = sum(math.prod(shapes[n]) for n in mats)
    gen = torch.Generator(device=torch.device(device)).manual_seed(
        fold_in(seed, WEIGHT_STREAM))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n in names:
        shape = tuple(shapes[n])
        if len(shape) >= 2:
            size = math.prod(shape)
            out[n] = flat[at:at + size].view(shape) * _std(shape)
            at += size
        else:
            value = next((v for rx, v in constants if rx.search(n)),
                         1.0 if n.endswith("weight") else 0.0)
            out[n] = torch.full(shape, float(value), device=device)
    return out


def load_weights(model: torch.nn.Module, seed: int, device,
                 constants=None) -> None:
    """Overwrite every parameter of `model` with the seed's weights."""
    params = dict(model.named_parameters())
    weights = make_weights({n: tuple(p.shape) for n, p in params.items()},
                           seed, device, constants)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
