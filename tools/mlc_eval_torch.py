#!/usr/bin/env python
"""Supervised finetune / eval of the MLC model with the PyTorch port
(sm3x_torch): writes best_eval.pth and a results.csv in the released layout.

    python tools/mlc_eval_torch.py --device cuda -a resnet50 --epochs 100 \\
        -b 128 -lr 1e-3 --finetune projector --mlc-proj v4 \\
        --mlc-proj-dim 512 --num-heads 1 --sa-dim-ff 128 --sa-dropout 0.1 \\
        --pretrain-path logs/mlc_train/ckp_149.pth --data-path ./data/7PC ...

Same flags as tools/mlc_eval.py, plus --device; --pretrain-path takes a
stage-2 checkpoint written by tools/mlc_train_torch.py or a released
best_linear.pth / best_finetune.pth.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sm3x_torch.cli.apps import mlc_eval_main  # noqa: E402

if __name__ == "__main__":
    mlc_eval_main()
