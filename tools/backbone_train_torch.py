#!/usr/bin/env python
"""Stage-1 SSL pretraining with the PyTorch port (sm3x_torch).

    python tools/backbone_train_torch.py --device cuda -a resnet50 \
        --arch-version v32 --proj-dim 128 --temperature 0.1 -b 96 \
        -lr 1e-6 --world-size 2 --amp --data-path ./data/7PC ...

Same flags as tools/backbone_train.py, plus --device.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sm3x_torch.cli.apps import backbone_train_main  # noqa: E402

if __name__ == "__main__":
    backbone_train_main()
