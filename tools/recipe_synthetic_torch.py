#!/usr/bin/env python
"""run_torch.sh, verbatim, on a synthetic Derm7pt tree at the release's
size, with the random-init control, and a summary of what each stage took
and reached.

    python tools/recipe_synthetic_torch.py --root build/recipe \\
        --summary build/recipe/summary.json
    python tools/recipe_synthetic_torch.py --stages "stage2_mlc stage2_eval"

Stages the tree once under ROOT/data with the port's
`make_fake_derm7pt(n_cases=1011, img_size=480, seed=0, splits=(413, 203,
395), structured=True, ext="jpg")`: label-correlated textures, JPEGs of
464-495 pixels a side. Then runs `run_torch.sh` with DATA, SSL_LOG
(ROOT/logs/backbone), MLC_LOG (ROOT/logs/mlc_train) and STAGES set (by
default stage1_ssl, stage1_eval, stage1_control, stage2_mlc, stage2_eval:
run.sh's four stages with the control after stage 1's probes), its output
in ROOT/run_torch.log. A later call with --stages goes on from the
checkpoints an earlier one left under ROOT.

The summary (printed, and written as JSON to --summary) holds each stage's
wall seconds from run_torch.sh's markers, the first and last SSL epoch
loss, each eval run's best val AUC_AVG (the 395-case test split), and the
ordering the method is read by: the control below the best SSL probe
below the best stage-2 eval.
"""

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = "stage1_ssl stage1_eval stage1_control stage2_mlc stage2_eval"
SPLITS = (413, 203, 395)   # the release's train / valid / test cases


def best_auc(run_dir: str):
    """The `Best val AUC_AVG` an eval app logged in `run_dir`, or None."""
    path = os.path.join(run_dir, "log.txt")
    if not os.path.exists(path):
        return None
    found = re.findall(r"Best val AUC_AVG: ([0-9.]+)", open(path).read())
    return float(found[-1]) if found else None


def summarise(root: str, run_log: str) -> dict:
    ssl_log = os.path.join(root, "logs", "backbone")
    mlc_log = os.path.join(root, "logs", "mlc_train")
    marks = {}
    if os.path.exists(run_log):
        for stage, edge, t in re.findall(r"=== (\w+):(start|end) (\d+) ",
                                         open(run_log).read()):
            marks.setdefault(stage, {})[edge] = int(t)
    seconds = {s: m["end"] - m["start"] for s, m in marks.items()
               if "end" in m}
    losses = []
    path = os.path.join(ssl_log, "log.txt")
    if os.path.exists(path):
        losses = [float(v) for v in re.findall(r"Epoch \d+: loss ([0-9.]+)",
                                               open(path).read())]
    probes = {e: best_auc(os.path.join(ssl_log, f"test_{e}"))
              for e in range(49, 400, 50)}
    evals = {e: best_auc(os.path.join(mlc_log, f"test_{e}"))
             for e in (49, 99, 149)}
    control = best_auc(os.path.join(ssl_log, "control"))
    best_probe = max([v for v in probes.values() if v is not None],
                     default=None)
    best_eval = max([v for v in evals.values() if v is not None],
                    default=None)
    order = None
    if None not in (control, best_probe, best_eval):
        order = control < best_probe < best_eval
    return {"seconds": seconds,
            "ssl_loss_first": losses[0] if losses else None,
            "ssl_loss_last": losses[-1] if losses else None,
            "ssl_epochs": len(losses), "control": control,
            "ssl_probes": probes, "stage2_evals": evals,
            "best_ssl_probe": best_probe, "best_stage2_eval": best_eval,
            "control_below_probe_below_eval": order}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.join(ROOT, "build", "recipe"))
    p.add_argument("--stages", default=STAGES)
    p.add_argument("--summary", default=None,
                   help="also write the summary here as JSON")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    data = os.path.join(root, "data")
    if not os.path.exists(os.path.join(data, "meta.csv")):
        from sm3x_torch.data.synthetic import make_fake_derm7pt

        make_fake_derm7pt(data, n_cases=sum(SPLITS), img_size=480, seed=0,
                          splits=SPLITS, structured=True, ext="jpg")
    run_log = os.path.join(root, "run_torch.log")
    env = dict(os.environ, DATA=data, DEVICE="cuda",
               SSL_LOG=os.path.join(root, "logs", "backbone"),
               MLC_LOG=os.path.join(root, "logs", "mlc_train"),
               STAGES=args.stages)
    with open(run_log, "a") as f:
        rc = subprocess.run(["bash", os.path.join(ROOT, "run_torch.sh")],
                            cwd=ROOT, env=env, stdout=f,
                            stderr=subprocess.STDOUT).returncode
    from sm3x_torch.utils.timing import nvidia_smi_name_and_limit

    summary = dict(summarise(root, run_log), run_torch_rc=rc,
                   device=nvidia_smi_name_and_limit())
    text = json.dumps(summary)
    print(text)
    if args.summary:
        with open(args.summary, "w") as f:
            f.write(text + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
