#!/usr/bin/env python
"""Minimal public inference script of the PyTorch port (the twin of
inference.py).

Rebuilds the released SM3 model (dual ResNet-50 extractor, 8 per-label
projectors, 1 transformer-encoder mixing layer, 8 prototype heads), loads
`best_linear.pth` / `best_finetune.pth` (or a `best_eval.pth` of the port's
eval stage) strictly, and runs a dummy forward on the GPU, the encoders in
bf16 as the JAX package's script runs them:

    python inference_torch.py [best_finetune.pth] [--device cuda]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sm3x_torch import CLASSES_NAME, CLS_WEIGHTS, NUM_CLASSES  # noqa: E402,F401
from sm3x_torch.api import build_evaluator, load_weights, predict_fn  # noqa: E402,F401


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pretrain_path", nargs="?", default="./best_finetune.pth")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)

    arch = "resnet50"
    mlc_proj_dim = 512
    num_labels = 8
    l2_norm = False
    num_heads = 1
    sa_dim_ff = 128
    sa_dropout = 0.1

    evaluator = build_evaluator(arch, mlc_proj_dim, num_labels, l2_norm,
                                num_heads, sa_dim_ff, sa_dropout)
    print(f"Loading pre-trained weights from '{args.pretrain_path}' ...")
    load_weights(evaluator, args.pretrain_path, args.device)
    print(f"loaded pre-trained model weights from '{args.pretrain_path}'")

    fwd = predict_fn(evaluator)
    dummy_derm = np.random.randn(1, 224, 224, 3).astype(np.float32)
    dummy_clinic = np.random.randn(1, 224, 224, 3).astype(np.float32)
    preds = fwd(dummy_derm, dummy_clinic)
    for name, pred in zip(CLASSES_NAME, preds):
        print(name, pred.cpu().numpy())


if __name__ == "__main__":
    main()
