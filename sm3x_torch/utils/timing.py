"""Clocks for a CUDA device, shared by `chip_smoke.py`, `bench_torch.py`
and the `tools/*_torch.py` probes. Every function here needs a card except
`nvidia_smi_name_and_limit`, which needs only `nvidia-smi`.

Three clocks, from the host's view to the card's own:
  `median_ms`   one call between two events: the wrapper's host work counts
  `device_ms`   events around many calls in a row: the host runs ahead, so
                for a kernel longer than the host's work a call this is the
                kernel; for a shorter one it reads the host
  `kernel_ms`   the kernels' own time from torch.profiler: no host work
and `profile_device`, the same profiler over whole training steps.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def nvidia_smi_name_and_limit(index: int = 0) -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() over reps calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 50) -> float:
    """Device time of one fn(): events around `reps` launches in a row,
    after a warm-up, over the count. The host runs ahead of the card, so
    its work before each launch is hidden behind the launch before."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_events(prof):
    """(rows, field): the kernels and copies of a torch.profiler profile,
    longest first, and the name of their device-time field in this torch.
    An op's row, and a range such as the optimizer step's user annotation,
    repeat the time of the kernels inside them and are left out."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    field = ("self_device_time_total" if rows and hasattr(
        rows[0], "self_device_time_total") else "self_cuda_time_total")
    return sorted(rows, key=lambda e: -getattr(e, field)), field


def _profile(fn, n: int):
    """torch.profiler over fn(0) .. fn(n - 1): (the profile, host-clock us).
    The device's activity alone: every reader takes the device rows, and
    the host's operator events cost seconds to gather a window of
    training steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def kernel_ms(fn, reps: int = 20):
    """The kernels' own time of one fn(): every kernel the call launches,
    summed from torch.profiler's device events over `reps` calls. Unlike
    `device_ms` it holds none of the host's work between launches. The
    profiler now and then returns no device event for a short window: the
    window is then made longer, twice, and after that the result is None
    (not measured)."""
    fn()
    for n in (reps, 5 * reps, 25 * reps):
        prof, _ = _profile(lambda _: fn(), n)
        rows, field = device_events(prof)
        total_us = sum(getattr(e, field) for e in rows)
        if total_us > 0:
            return total_us / n / 1e3
    return None


def profile_device(step, n: int) -> dict:
    """torch.profiler over step(0) .. step(n - 1): the device's busy ms a
    step (the sum of kernel and copy times), kernels and copies a step, the
    host-clock ms a step of the profiled window, and the profile with its
    kernel rows for a table. Raises if no device time was recorded."""
    prof, wall_us = _profile(step, n)
    rows, field = device_events(prof)
    busy_us = sum(getattr(e, field) for e in rows)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return dict(busy_ms=busy_us / n / 1e3,
                launches=sum(e.count for e in rows) / n,
                wall_ms=wall_us / n / 1e3, rows=rows, field=field, prof=prof)
