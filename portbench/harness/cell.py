"""One run of a cell: set-up, the measured window, the per-layer readers
over the traced slice, then the reference and the verdict. `run.py` calls
`run_cell` on the card; the tests call it on the CPU at a toy size."""

from __future__ import annotations

import sys
import time

import torch

from portbench.harness import checks, clock, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sm3x")
GIB = 1 << 30


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is the JAX
    stack's or the JAX package's (`sm3x_torch` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def per_layer(run, cell, win: dict, shapes: dict) -> dict:
    """{metric: value} of every reader that found something to read."""
    intervals = clock.intervals_ms(win["step_ends_ms"], win["start_ms"])
    ctx = dict(cell=cell, slice=run.tracer.slice, spans=run.spans,
               boundaries=run.boundaries, window=win, shapes=shapes,
               step_s=1e-3 * sum(intervals) / len(intervals))
    out = {}
    for name, reader in spec.metric_readers().items():
        value = reader.read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": reader.UNIT}
    return out


def run_cell(cell, seed: int, seconds: float, traced: bool, t_start: float,
             device: str = "cuda", fault=None) -> tuple:
    """(result, check lines) of one run; `t_start` is the process's start
    on the host's clock."""
    on_card = device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    stage = spec.load_stage(cell)
    run = stage.Run(cell, seed, device, fault)
    run.build()
    prog = run.first_epoch()
    setup_s = time.perf_counter() - t_start
    win = run.window(seconds, traced)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    intervals = clock.intervals_ms(win["step_ends_ms"], win["start_ms"])
    metrics, extra = {}, {}
    if traced:
        sl = run.tracer.slice
        metrics = per_layer(run, cell, win, stage.step_shapes(cell))
        extra = dict(busy_s=sl.busy_s, window_s=sl.window_s)
        breakdown = trace.breakdown(sl, run.spans, run.boundaries)
    else:
        metrics = {
            "train_cases_per_s": {"value": clock.rate(win["cases"],
                                                      win["wall_s"]),
                                  "unit": "cases/s"},
            "step_ms_p90": {"value": clock.p90(intervals), "unit": "ms"},
            "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    split = run.split
    run.free()
    ref = stage.reference(cell, split, seed, device)
    found = checks.gaps(prog, ref)
    correct, numbers = checks.judge(found, cell.workload["limits"])
    lines = [f"{name}: {numbers[name]['value']!r} (limit "
             f"{numbers[name]['limit']!r}; worst at {found[name][1]})"
             for name in numbers]
    result = {"correct": correct, "attempted": win["steps"],
              "failed": win["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": peak, **extra}}
    if traced:
        result["breakdown"] = breakdown
    result["checks"] = numbers
    return result, lines

