#!/usr/bin/env python
"""Shim to `sm3x_torch.export:main` (installed as `sm3x-torch-export-aot`):
export a trained or released MLC checkpoint to a self-contained AOT serving
artifact (a torch.export program per batch bucket per device type, weights
baked in). Serve it with
    sm3x-torch-serve --exported-path <out-dir>

Usage:
  python tools/export_model_torch.py --pretrain-path best_eval.pth \
      --out artifact/ [--arch resnet50] [--buckets 1 8 32] \
      [--platforms cpu cuda]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sm3x_torch.export import main  # noqa: E402

if __name__ == "__main__":
    main()
