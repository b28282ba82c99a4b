#!/usr/bin/env python
"""Controls for chip_smoke.py's [dist] checks: the phase run on copies of
the checkout, each with one deliberate fault in the global-batch BatchNorm,
to show what the checks read when the distributed path is wrong.

    python3 tools/dist_controls_torch.py [--timeout SECONDS]

Needs a CUDA card. Each control copies the checkout (without build/ and
chiprun_out/) into a temporary directory, changes one line of
sm3x_torch/models/layers.py, and runs `python3 chip_smoke.py --only dist`
there; the checkout itself is not touched. Controls:

  half-batch statistics   the forward's statistics from the first half of
                          the rank's rows (what a rank's own statistics
                          are against the global batch's)
  rank-local backward     the backward's two sums not summed over the
                          ranks (world size 1 cannot see it; leg B can)

For each it prints the [dist] lines that hold a reading (losses, shares,
the BatchNorm errors) and the exit code, which a control must make
non-zero; the last line is one JSON object with, per control, the largest
loss distance of each leg A check, the shares of parameters beyond
0.1 x lr and the largest BatchNorm error."""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = os.path.join("sm3x_torch", "models", "layers.py")

CONTROLS = {
    "half-batch statistics": (
        "mean, invstd = torch.batch_norm_stats(x, EPS)",
        "mean, invstd = torch.batch_norm_stats(x[: x.shape[0] // 2], EPS)"),
    "rank-local backward": (
        "sums = all_reduce_sum(torch.cat([sum_dy, sum_dy_xmu]))",
        "sums = torch.cat([sum_dy, sum_dy_xmu])"),
}

READING = re.compile(r"step \d+: loss|parameters after|BatchNorm\(\d+\) on|"
                     r"kernel launches a step|leg [ABC]|Error")


def summarise(text: str) -> dict:
    out = {"loss_rel": {}, "share_pct": [], "bn_err_max": None}
    for ln in text.splitlines():
        m = re.search(r"(leg A \w+) against the plain trainer step \d+: .*"
                      r"relative ([0-9.e+-]+)", ln)
        if m:
            tag, rel = m.group(1), float(m.group(2))
            out["loss_rel"][tag] = max(out["loss_rel"].get(tag, 0.0), rel)
        m = re.search(r"([0-9.]+)% of entries beyond", ln)
        if m:
            out["share_pct"].append(float(m.group(1)))
        if "BatchNorm(" in ln and "relative error" in ln:
            errs = [float(e) for e in re.findall(
                r"(?:y|dx|dw|db|running_mean|running_var) ([0-9.e+-]+)", ln)]
            top = max(errs, default=0.0)
            out["bn_err_max"] = max(out["bn_err_max"] or 0.0, top)
    return out


def run_control(name: str, old: str, new: str, timeout: float) -> dict:
    where = tempfile.mkdtemp(prefix="sm3x_control_")
    try:
        copy = os.path.join(where, "repo")
        shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
            ".git", "build", "chiprun_out", "__pycache__"))
        path = os.path.join(copy, LAYERS)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the line to change is not in "
                             f"{LAYERS} once")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
        print(f"[control] {name}: {old!r} -> {new!r}", flush=True)
        try:
            res = subprocess.run(
                [sys.executable, "chip_smoke.py", "--only", "dist"],
                cwd=copy, capture_output=True, text=True, timeout=timeout,
                env=dict(os.environ, PYTHONPATH=copy))
            rc, text = res.returncode, res.stdout + res.stderr
        except subprocess.TimeoutExpired as e:
            rc = 124
            text = "".join(x.decode() if isinstance(x, bytes) else (x or "")
                           for x in (e.stdout, e.stderr))
        for ln in text.splitlines():
            if READING.search(ln):
                print(f"  {ln.strip()}", flush=True)
        print(f"[control] {name}: exit code {rc}", flush=True)
        return dict(summarise(text), rc=rc)
    finally:
        shutil.rmtree(where, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--timeout", type=float, default=400.0,
                   help="seconds each control's run may take")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 1
    result = {name: run_control(name, old, new, args.timeout)
              for name, (old, new) in CONTROLS.items()}
    print(json.dumps(result), flush=True)
    # a control that passes every check shows a check that cannot fail
    return 0 if all(r["rc"] not in (0, 124) for r in result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
