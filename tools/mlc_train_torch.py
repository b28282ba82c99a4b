#!/usr/bin/env python
"""Stage-2 DeepCluster MLC training with the PyTorch port (sm3x_torch).

    python tools/mlc_train_torch.py --device cuda -a resnet50 \\
        --epochs 150 -b 256 -lr 1e-4 --temperature 1 --mlc-proj v4 \\
        --mlc-proj-dim 512 --num-heads 1 --sa-dim-ff 128 --sa-dropout 0.1 \\
        --extractor-weights logs/ssl/ckp_399.pth --data-path ./data/7PC ...

Same flags as tools/mlc_train.py, plus --device; --extractor-weights takes
a stage-1 checkpoint written by tools/backbone_train_torch.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sm3x_torch.cli.apps import mlc_train_main  # noqa: E402

if __name__ == "__main__":
    mlc_train_main()
