#!/usr/bin/env python3
"""The benchmark of sm3x_torch, the PyTorch / CUDA port of SM3, on NVIDIA
GPUs: one run of one cell.

    python3 portbench/run.py --workload r50_ssl_recipe --seed 7 \\
        --seconds 45 --trace 0

Set-up builds the cell's trainer, feed and inputs from the seed and trains
its first epoch, whose first steps the plain reference follows; the window
then trains whole epochs for `--seconds`. With `--trace 0` the last line of
standard output is the result with the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from whole epochs profiled after
the window. The numbers that decide `correct` are the last lines of standard
error and the `checks` of the result. It exits non-zero, printing no
result, without a card or enough of them, without the program beside it,
or when the JAX stack or the JAX package was loaded.
"""

import os
import time

T_START = time.perf_counter()
# One OpenMP thread, set before torch loads: spinning OpenMP workers take
# host time from the thread that launches the kernels. Four runs of the
# host-bound ViT cell on one H100 ranged over 20% in rate with them, 4%
# without.
os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_and_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(CHECKOUT, "sm3x_torch")):
        print("portbench: the program (sm3x_torch) is not beside the "
              "benchmark in this checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, CHECKOUT)
    import torch

    from portbench.harness import spec
    from portbench.harness.cell import forbidden_modules, run_cell

    cell = spec.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    result, lines = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}, which the port "
              "must not load", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card_and_limit()
    result["checks"] = checks
    print(f"portbench: {args.workload} seed {args.seed}: correct "
          f"{result['correct']}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
