#!/usr/bin/env python
"""ISIC transfer probe with the PyTorch port (sm3x_torch): one modality's
frozen stage-1 encoder under linear heads on a single-image dataset.

    python tools/transfer_probe_torch.py --device cuda \
        --pretrain-path <stage-1 log>/ckp_399.pth --data-name ISIC17Dataset \
        --data-path ./data/ISIC2017 -a resnet50 --modality derm -b 64

Same flags as `sm3x-probe-transfer`, plus --device.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sm3x_torch.train.transfer_probe import main  # noqa: E402

if __name__ == "__main__":
    main()
