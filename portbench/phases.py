#!/usr/bin/env python3
"""Where a stage-1 cell's host time and the card's idle gaps go, phase by
phase, read from the program's own spans and counters
(`sm3x_torch.utils.profiling`): one run of a cell as `run.py` runs it, with
the port's recorder on from the window's start.

    python3 portbench/phases.py --workload r50_ssl_recipe --seed 7 \\
        --seconds 51 --trace 1

Prints one JSON line: the window's rate; host ms a step in each phase
(`PHASES`), thread CPU ms a step in `trainer.step` and device waits a step,
over the window's spans and steps; spans a step; the ns of a span with the
recorder on and off. One more epoch then runs under
`torch.cuda.set_sync_debug_mode("warn")`: the synchronising calls it
reports, by the line that made them, beside `host.device_waits` over the
same epoch. With `--trace 1`, one untraced epoch and the cell's traced
epochs follow the window, as in `run.py`, and the line adds the idle gaps
of that slice by `<benchmark span>/<innermost program span>` (the program
span recorded on the launching thread that covers the gap's start), the
share of idle time in no program span, the benchmark's own per-layer
metrics, and how far the first K1 launch of an `augment.views` span
starts on the device before the span began (the clocks' agreement).
The plain reference is not run, so no `correct` is printed.
"""

import os
import time

T_START = time.perf_counter()
os.environ["OMP_NUM_THREADS"] = "1"   # as run.py sets it

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASES = {  # reading: the program span whose host ms a step it sums
    "feed.upload_wait_ms_per_step": "feed.upload",
    "augment.host_ms_per_step": "augment.views",
    "model.forward_host_ms_per_step": "model.forward",
    "trainer.backward_host_ms_per_step": "trainer.backward",
    "trainer.optimizer_host_ms_per_step": "trainer.optimizer",
}
K1 = r"photometric_(?:band|scratch)_kernel"
WAITS = "host.device_waits"
SYNC = "called a synchronizing CUDA operation"   # the sync debug mode's


def host_ms_per_step(spans, name: str, end_s: float, steps: int):
    """Host ms a step in the spans `name` that began before `end_s`."""
    total = sum(s.end_ns - s.start_ns for s in spans
                if s.name == name and s.start_ns * 1e-9 < end_s)
    return 1e-6 * total / steps if steps else None


def cpu_ms_per_step(spans, end_s: float, steps: int):
    """Thread CPU ms a step inside `trainer.step`."""
    total = sum(s.cpu_ns[1] - s.cpu_ns[0] for s in spans
                if s.name == "trainer.step" and s.cpu_ns is not None
                and s.start_ns * 1e-9 < end_s)
    return 1e-6 * total / steps if steps else None


def innermost(t: float, spans, thread: int):
    """The deepest span of `thread` open at `t` (seconds), or None."""
    best = None
    for s in spans:
        if (s.thread == thread and s.start_ns * 1e-9 <= t < s.end_ns * 1e-9
                and (best is None or s.start_ns > best.start_ns)):
            best = s
    return best


def phase_label(t: float, bench_spans, boundaries, spans, thread: int) -> str:
    """The benchmark's label of `t` (`trace.label`), with the innermost
    program span of the launching thread after a slash where one covers
    it."""
    from portbench.harness.trace import label

    base = label(t, bench_spans, boundaries)
    inner = innermost(t, spans, thread)
    return base if inner is None else f"{base}/{inner.name}"


def idle_by_phase(gaps, bench_spans, boundaries, spans, thread: int) -> dict:
    """{label: idle seconds} over `gaps` [(start_s, length_s)], longest
    first, and the share of the idle time that no program span covers."""
    by, bare = {}, 0.0
    for a, length in gaps:
        name = phase_label(a, bench_spans, boundaries, spans, thread)
        by[name] = by.get(name, 0.0) + length
        if "/" not in name:
            bare += length
    total = sum(length for _, length in gaps)
    return {"idle_s": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "unlabelled_share": bare / total if total else None}


def k1_leads_ms(sl, spans, thread: int):
    """For each `augment.views` span of the slice `sl`, in order, the ms by
    which its first K1 launch starts on the device before the span began
    (negative: after it). Each span launches its views' K1s in order, as
    many a span, so the k-th span's first is launch k x (launches /
    spans); None where the slice has no K1 or they do not divide evenly."""
    launches = sorted(a for _, a, _ in sl.matching(K1))
    views = sorted(s.start_ns * 1e-9 for s in spans
                   if s.name == "augment.views" and s.thread == thread
                   and sl.start_s <= s.start_ns * 1e-9 < sl.end_s)
    if not launches or not views or len(launches) % len(views):
        return None
    per = len(launches) // len(views)
    return [1e3 * (v - launches[i * per]) for i, v in enumerate(views)]


def span_ns(n: int = 100_000) -> dict:
    """ns of one empty `annotate` region: off, and on as a root (which
    reads the thread's CPU clock too) and as a child."""
    from sm3x_torch.utils import profiling

    def timed(outer):
        with outer:
            t = time.perf_counter_ns()
            for _ in range(n):
                with profiling.annotate("cost"):
                    pass
            return (time.perf_counter_ns() - t) / n

    out = {"off": timed(profiling.annotate("outer"))}
    profiling.record(True)
    out["on_root"] = timed(contextlib.nullcontext())
    out["on_child"] = timed(profiling.annotate("outer"))
    profiling.record(False)
    profiling.take()
    return out


def sync_check(run, epoch: int) -> dict:
    """One epoch under the sync debug mode: the synchronising calls it
    reports, by the line that made them, and the counter beside them."""
    import torch

    from sm3x_torch.utils import profiling

    where, other = {}, []

    def seen(message, category, filename, lineno, file=None, line=None):
        if SYNC not in str(message):
            other.append(f"{filename}:{lineno}: {str(message)[:160]}")
            return
        mine = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(CHECKOUT)
                and not f.filename.startswith(os.path.abspath(__file__))]
        key = (f"{os.path.relpath(mine[-1].filename, CHECKOUT)}:"
               f"{mine[-1].lineno}" if mine else f"{filename}:{lineno}")
        where[key] = where.get(key, 0) + 1

    torch.cuda.synchronize()
    profiling.take()
    profiling.record(True)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run._epoch(epoch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            profiling.record(False)
    counted = profiling.take().counters.get(WAITS, 0)
    return {"steps": run.steps_per_epoch, "reported": sum(where.values()),
            "counted": counted, "where": where, "other_warnings": other}


def phases(cell, seed: int, seconds: float, traced: bool) -> dict:
    """The line `main` prints, for one run of `cell` on the card."""
    from portbench.harness import cell as cells
    from portbench.harness import clock, spec
    from sm3x_torch.utils import profiling

    stage = spec.load_stage(cell)
    run = stage.Run(cell, seed, "cuda", None)
    run.build()
    run.first_epoch()
    setup_s = time.perf_counter() - T_START
    thread = threading.get_ident()
    profiling.take()
    profiling.record(True)
    win = run.window(seconds, False)
    profiling.record(False)
    rec = profiling.take()
    steps, end_s = win["steps"], win["end_s"]
    out = {"train_cases_per_s": clock.rate(win["cases"], win["wall_s"]),
           "setup_s": setup_s, "steps": steps,
           "spans_per_step": sum(s.start_ns * 1e-9 < end_s
                                 for s in rec.spans) / steps,
           "dropped": rec.dropped}
    for name, span in PHASES.items():
        out[name] = host_ms_per_step(rec.spans, span, end_s, steps)
    out["trainer.host_cpu_ms_per_step"] = cpu_ms_per_step(rec.spans, end_s,
                                                          steps)
    out["trainer.host_waits_per_step"] = rec.counters.get(WAITS, 0) / steps
    out["counters"] = rec.counters
    if traced:
        profiling.record(True)
        run.window(0, True)
        profiling.record(False)
        sl = run.tracer.slice
        a, b = sl.start_s - 1.0, sl.end_s    # what the slice's gaps can meet
        spans = [s for s in profiling.take().spans
                 if s.start_ns * 1e-9 < b and s.end_ns * 1e-9 > a]
        bench = [s for s in run.spans if s[1] < b and s[2] > a]
        bounds = [s for s in run.boundaries if s[0] < b and s[1] > a]
        gaps = sl.gaps()
        out["slice"] = {"busy_s": sl.busy_s, "window_s": sl.window_s,
                        "steps": sl.steps}
        out["gaps"] = idle_by_phase(gaps, bench, bounds, spans, thread)
        out["longest_gaps"] = [
            [phase_label(t, bench, bounds, spans, thread), length]
            for t, length in sorted(gaps, key=lambda g: -g[1])[:10]]
        leads = k1_leads_ms(sl, spans, thread)
        out["k1_lead_ms"] = None if leads is None else max(leads)
        out["k1_leads_ms"] = leads
        out["per_layer"] = cells.per_layer(run, cell, win,
                                           stage.step_shapes(cell))
    out["sync_check"] = sync_check(run, 10 ** 4)  # past the window's epochs
    out["span_ns"] = span_ns()
    run.free()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, CHECKOUT)
    import torch

    from portbench.harness import spec
    from portbench.run import card_and_limit

    if not torch.cuda.is_available():
        print("portbench.phases: needs a CUDA device", file=sys.stderr)
        return 1
    cell = spec.load_cell(args.workload)
    out = phases(cell, args.seed, args.seconds, bool(args.trace))
    out.update(workload=args.workload, seed=args.seed,
               card=card_and_limit())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
