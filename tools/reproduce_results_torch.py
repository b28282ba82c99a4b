#!/usr/bin/env python
"""Reproduce a results CSV from a checkpoint with the PyTorch port
(sm3x_torch): evaluate a best_eval.pth of the port's eval stage, or a
released best_linear.pth / best_finetune.pth, over the Derm7pt test split,
write the CSV in the released layout, and optionally diff every cell
against a reference CSV.

    python tools/reproduce_results_torch.py --pretrain-path best_finetune.pth \\
        --data-path ./data/7PC --out results.csv --fp32 \\
        --compare /path/to/finetune_results.csv --tolerance 0.2
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sm3x_torch.reproduce import compare_csv, evaluate, main  # noqa: E402,F401

if __name__ == "__main__":
    main()
