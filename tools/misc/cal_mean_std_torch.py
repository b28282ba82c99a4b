#!/usr/bin/env python
"""A dataset's channel mean and std for --mean / --std, with the PyTorch
port (the twin of tools/misc/cal_mean_std.py).

    python tools/misc/cal_mean_std_torch.py --data-path ./data/7PC

Decodes the train split's derm and clinic images once into the port's
uint8 canvases (sm3x_torch.data.pipeline.ImageStore: the 25-pixel border
crop, then the letterbox) and reduces over the valid pixels only, never
the letterbox padding: a float32 sum a canvas, accumulated in float64.
Prints two lines, `mean: r g b` and `std:  r g b`.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def channel_mean_std(store):
    """(mean, std), each (3,) float64, over the valid pixels of every
    canvas of `store`."""
    total = np.zeros(3, np.float64)
    total_sq = np.zeros(3, np.float64)
    count = 0
    for canvas, (h, w) in zip(store.canvases, store.valid_hw):
        x = torch.from_numpy(np.ascontiguousarray(canvas[:h, :w])).float()
        x = x / 255.0
        total += x.sum(dim=(0, 1)).double().numpy()
        total_sq += (x * x).sum(dim=(0, 1)).double().numpy()
        count += int(h) * int(w)
    mean = total / count
    std = np.sqrt(total_sq / count - mean ** 2)
    return mean, std


def main(argv=None):
    from sm3x_torch.data.derm7pt import Derm7ptMeta
    from sm3x_torch.data.pipeline import ImageStore

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-path", required=True)
    p.add_argument("--cache-size", type=int, default=512)
    args = p.parse_args(argv)

    meta = Derm7ptMeta(args.data_path)
    derm, clinic, _ = meta.examples("train")
    store = ImageStore(derm + clinic, args.cache_size, meta.crop_amount)
    mean, std = channel_mean_std(store)
    print("mean:", " ".join(f"{v:.4f}" for v in mean))
    print("std: ", " ".join(f"{v:.4f}" for v in std))


if __name__ == "__main__":
    main()
