#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size,
many seeds in one process (set-up is long; no window is needed: a training
cell's numbers are read from its first steps).

    python3 portbench/calibrate.py --workload r50_ssl_recipe \\
        --seeds 11 12 13 --control-seeds 11 12 13 --fault-seeds 21 22 23 \\
        --out chiprun_out/calibrate_r50.jsonl

For each seed of `--seeds` the program's first steps against the
reference's (`program`); for each of `--control-seeds` the control, the
reference in the next precision down, against the reference (`control`);
for each of `--fault-seeds` the program with half of each batch left out
of the loss (`half_batch`; a state left unchanged reads 1 on the gradient
and change gaps by their definition and needs no run). One JSON line a
reading, with each number and the leaf or step it is worst at.
"""

import argparse
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, CHECKOUT)
    import torch

    from portbench.harness import checks, spec
    from portbench.harness.inputs import paired_split

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    cell = spec.load_cell(args.workload)
    stage = spec.load_stage(cell)
    first_steps = stage.reference
    t = cell.traffic
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, found, t0, **extra):
        line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                           **{k: v[0] for k, v in found.items()},
                           "where": {k: v[1] for k, v in found.items()},
                           "seconds": time.perf_counter() - t0, **extra})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(seed, fault=None):
        run = stage.Run(cell, seed, "cuda", fault)
        run.build()
        readings = run.first_epoch()
        split = run.split
        run.free()
        return readings, split

    refs = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog, split = program(seed)
        refs[seed] = first_steps(cell, split, seed, "cuda")
        emit("program", seed, checks.gaps(prog, refs[seed]), t0,
             losses=prog.losses)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        split = paired_split(t["cases"], t["canvas"], seed)
        ref = refs.get(seed) or first_steps(cell, split, seed, "cuda")
        ctl = first_steps(cell, split, seed, "cuda", numerics="fp8")
        emit("control", seed, checks.gaps(ctl, ref), t0)
    for seed in args.fault_seeds:
        t0 = time.perf_counter()
        prog, split = program(seed, "half_batch")
        ref = refs.get(seed) or first_steps(cell, split, seed, "cuda")
        emit("half_batch", seed, checks.gaps(prog, ref), t0)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
