"""Reproduce a results CSV from a checkpoint (counterpart of
sm3x/reproduce.py).

The reference's quality lock: run a released best_linear.pth /
best_finetune.pth over the Derm7pt test split and match
linear_results.csv / finetune_results.csv. This module loads such a `.pth`
(or a `best_eval.pth` of the port's eval stage), evaluates the test split,
writes the CSV in the released layout, and optionally diffs every cell
against a reference CSV.

    python tools/reproduce_results_torch.py --pretrain-path best_finetune.pth \\
        --data-path ./data/7PC --out results.csv --fp32 \\
        --compare /path/to/finetune_results.csv --tolerance 0.2

`--fp32` is float32 arithmetic with TF32 off; without it the encoders run
under bf16 autocast. `--device` picks the card (the default) or the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch


def evaluate(pretrain_path, data_path, arch="resnet50", mlc_proj_dim=512,
             sa_dim_ff=128, batch_size=64, cache_size=320, test_sz=224,
             mean=(0.7833, 0.6712, 0.6026), std=(0.2139, 0.2472, 0.2571),
             fp32=False, device="cuda"):
    """(preds_list, targets) of the test split, padding removed."""
    from sm3x_torch.api import build_evaluator, load_weights
    from sm3x_torch.data.datasets import SevenPCBaseDataset
    from sm3x_torch.ops.augment import eval_resize_batch
    from sm3x_torch.train.supervised import (_concat_masked, full_float32,
                                             upload_batch)

    model = load_weights(
        build_evaluator(arch=arch, mlc_proj_dim=mlc_proj_dim,
                        sa_dim_ff=sa_dim_ff, amp=not fp32, img_size=test_sz),
        pretrain_path, device)

    @torch.inference_mode()
    def eval_step(derm, derm_hw, clinic, clinic_hw):
        d = eval_resize_batch(derm, derm_hw, mean, std, (test_sz, test_sz))
        c = eval_resize_batch(clinic, clinic_hw, mean, std,
                              (test_sz, test_sz))
        return model(d, c)[1]

    data = SevenPCBaseDataset(data_path, "test", cache_size=cache_size)
    all_preds, all_targets, all_masks = [], [], []
    # no module to switch: the model was built without autocast under --fp32
    with full_float32() if fp32 else contextlib.nullcontext():
        for batch in data.batches(batch_size, epoch=0, shuffle=False):
            all_preds.append(eval_step(*upload_batch(batch, device)))
            all_targets.append(batch.label)
            all_masks.append(batch.mask)
        return _concat_masked(all_preds, all_targets, all_masks)


def compare_csv(ours: str, reference: str, tolerance: float = 0.2):
    """Cell-by-cell diff; returns (n_bad, report lines).

    Cells are matched by column name, not position, and a column present
    in only one file is a failure: a reordered or truncated CSV must not
    pass the quality lock."""
    import csv

    def read(path):
        with open(path) as f:
            rows = list(csv.reader(f))
        header = rows[0][1:]
        table = {r[0]: [float(v) for v in r[1:]] for r in rows[1:]}
        return header, table

    h1, t1 = read(ours)
    h2, t2 = read(reference)
    report = []
    n_bad = 0
    for name in h2:
        if name not in h1:
            report.append(f"MISSING column {name}")
            n_bad += 1
    for name in h1:
        if name not in h2:
            report.append(f"EXTRA column {name}")
            n_bad += 1
    col_of = {name: i for i, name in enumerate(h1)}
    for metric in t2:
        if metric not in t1:
            report.append(f"MISSING metric row {metric}")
            n_bad += 1
            continue
        for j, name in enumerate(h2):
            if name not in col_of:
                continue  # already reported as a missing column
            a = t1[metric][col_of[name]]
            b = t2[metric][j]
            if abs(a - b) > tolerance:
                report.append(f"{metric}/{name}: ours {a:.3f} vs ref {b:.3f} "
                              f"(|d|={abs(a - b):.3f})")
                n_bad += 1
    return n_bad, report


def _preflight(args):
    """Fail fast, naming every missing artifact: the message is the staging
    checklist for the day the released weights and data are at hand."""
    import os

    missing = []
    if not os.path.exists(args.pretrain_path):
        missing.append(
            f"  --pretrain-path {args.pretrain_path}: not found. Stage the "
            f"released checkpoint (best_linear.pth / best_finetune.pth from "
            f"the skin-sm3 release, or a best_eval.pth of the port's eval "
            f"stage) at this path.")
    meta_csv = os.path.join(args.data_path, "meta.csv")
    if not os.path.exists(meta_csv):
        missing.append(
            f"  --data-path {args.data_path}: {meta_csv} not found. Stage "
            f"the Derm7pt release here (meta.csv + images/ with the "
            f"referenced derm/clinic files, plus "
            f"{{train,valid,test}}_indexes.csv).")
    if args.compare and not os.path.exists(args.compare):
        missing.append(
            f"  --compare {args.compare}: not found. Stage the released "
            f"linear_results.csv / finetune_results.csv to lock against.")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        missing.append(
            f"  --device {args.device}: torch.cuda.is_available() is false. "
            f"Run on a machine with an NVIDIA GPU, or pass --device cpu.")
    if missing:
        sys.exit("sm3x_torch reproduce: missing staged artifacts:\n"
                 + "\n".join(missing))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pretrain-path", required=True)
    p.add_argument("--data-path", required=True)
    p.add_argument("--out", default="results.csv")
    p.add_argument("--compare", default=None)
    p.add_argument("--tolerance", type=float, default=0.2)
    p.add_argument("-a", "--arch", default="resnet50")
    p.add_argument("--mlc-proj-dim", type=int, default=512)
    p.add_argument("--sa-dim-ff", type=int, default=128)
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--test-sz", type=int, default=224)
    p.add_argument("--cache-size", type=int, default=320)
    p.add_argument("--fp32", action="store_true",
                   help="float32 with TF32 off instead of bf16 autocast "
                   "(tight numeric parity against expectations computed "
                   "in float32)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, cuda:N or cpu)")
    p.add_argument("--mean", nargs=3, type=float,
                   default=[0.7833, 0.6712, 0.6026])
    p.add_argument("--std", nargs=3, type=float,
                   default=[0.2139, 0.2472, 0.2571])
    args = p.parse_args(argv)

    _preflight(args)

    from sm3x_torch.metrics import mean_average_precision, write_results_csv

    preds, targets = evaluate(
        args.pretrain_path, args.data_path, args.arch, args.mlc_proj_dim,
        args.sa_dim_ff, args.batch_size, cache_size=args.cache_size,
        test_sz=args.test_sz, mean=tuple(args.mean), std=tuple(args.std),
        fp32=args.fp32, device=args.device)
    write_results_csv(args.out, preds, targets)
    print(f"wrote {args.out}")

    ap = mean_average_precision(preds, targets)
    print(f"mAP_AVG {100 * ap['mAP_AVG']:.2f}  "
          f"mAP_SEL_AVG {100 * ap['mAP_SEL_AVG']:.2f}  (not part of the "
          f"released CSV layout)")

    if args.compare:
        n_bad, report = compare_csv(args.out, args.compare, args.tolerance)
        for line in report[:50]:
            print(line)
        print(f"{'PASS' if n_bad == 0 else 'FAIL'}: {n_bad} cells beyond "
              f"±{args.tolerance}")
        sys.exit(0 if n_bad == 0 else 1)


if __name__ == "__main__":
    main()
