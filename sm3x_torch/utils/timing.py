"""Clocks for a CUDA device, shared by `chip_smoke.py`, `bench_torch.py`
and the `tools/*_torch.py` probes. Every function here needs a card except
`nvidia_smi_name_and_limit`, which needs only `nvidia-smi`.

Three clocks, from the host's view to the card's own:
  `median_ms`   one call between two events: the wrapper's host work counts
  `device_ms`   events around many calls in a row: the host runs ahead, so
                for a kernel longer than the host's work a call this is the
                kernel; for a shorter one it reads the host
  `kernel_ms`   the kernels' own time from torch.profiler: no host work
and `profile_device`, the same profiler over whole training steps, and
`traced_launches`, each kernel's launches in its device trace.
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


MARKER_CYCLES = 100_000   # a spin kernel of ~50 us on an H100
TRACE_LEADS = (8, 64, 512)   # spin kernels that open a window, a try


def _profile(fn, n: int):
    """torch.profiler over fn(0) .. fn(n - 1): (the device rows and their
    time field, as `device_events` gives them, the profile, the calls'
    host-clock us). The device's activity alone: every reader takes the
    device rows, and the host's operator events cost seconds to gather a
    window of training steps.

    The profiler can drop the first device events of a window, a few or
    all (H100, torch 2.11: after some dozens of windows in a process, one
    or two spin kernels that opened a window went missing, every other
    kernel there, or the window came back empty; host pauses of 10 ms to
    1 s at its ends changed nothing). So the tracer starts a step early
    (the profiler's warm-up, whose events it drops), spin kernels, left
    out of the rows, run to their end before the calls and one after
    them, and a window whose first or last device event is not a spin
    kernel is traced again, its calls included, opened by more spin
    kernels (TRACE_LEADS); then this raises. Under a process group of
    more than one rank every rank traces the same window and they retake
    it together."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    group = dist.is_initialized() and dist.get_world_size() > 1
    for lead in TRACE_LEADS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            prof.step()
            for _ in range(lead):
                torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            prof.step()
        order = sorted((e.time_range.start, "spin_kernel" in e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))
        lost = torch.tensor(float(not (order and order[0][1]
                                       and order[-1][1])))
        if group:
            if dist.get_backend() == "nccl":
                lost = lost.cuda()
            dist.all_reduce(lost, op=dist.ReduceOp.MAX)
        if not lost.item():
            rows, field = device_events(prof)
            return ([e for e in rows if "spin_kernel" not in e.key], field,
                    prof, wall_us)
    raise RuntimeError(f"the profiler lost the ends of a window "
                       f"{len(TRACE_LEADS)} times")


def kernel_ms(fn, reps: int = 20) -> float:
    """The kernels' own time of one fn(): every kernel and copy the call
    launches, summed from torch.profiler's device events over `reps` calls
    after one more. Unlike `device_ms` it holds none of the host's work
    between launches."""
    fn()
    return profile_device(lambda _: fn(), reps)["busy_ms"]


def profile_device(step, n: int) -> dict:
    """torch.profiler over step(0) .. step(n - 1) (`_profile`): the
    device's busy ms a step (the sum of kernel and copy times), kernels and
    copies a step, the host-clock ms a step of the profiled window, and the
    profile with its kernel rows for a table."""
    rows, field, prof, wall_us = _profile(step, n)
    busy_us = sum(getattr(e, field) for e in rows)
    return dict(busy_ms=busy_us / n / 1e3,
                launches=sum(e.count for e in rows) / n,
                wall_ms=wall_us / n / 1e3, rows=rows, field=field, prof=prof)


def traced_launches(fn, n: int = 1) -> dict:
    """Each kernel's launches in the device trace of fn(0) .. fn(n - 1), by
    `sm3x_torch.ops.DEVICE_KERNELS`. A lost trace is taken again
    (`_profile`), so a caller that keeps what fn gives keeps its last n."""
    from sm3x_torch.ops import device_launches

    return device_launches(profile_device(fn, n)["rows"])
