#!/usr/bin/env python
"""Backbone linear eval with the PyTorch port (sm3x_torch): the two encoders
of a stage-1 checkpoint under eight linear heads; writes best_eval.pth and a
results.csv in the released layout.

    python tools/backbone_eval_torch.py --device cuda -a resnet50 \\
        --epochs 50 -b 128 -lr 1e-3 --finetune fc --amp \\
        --pretrain-path logs/backbone/ckp_399.pth --data-path ./data/7PC ...

Same flags as tools/backbone_eval.py, plus --device; --pretrain-path takes
a stage-1 checkpoint written by tools/backbone_train_torch.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sm3x_torch.cli.apps import backbone_eval_main  # noqa: E402

if __name__ == "__main__":
    backbone_eval_main()
