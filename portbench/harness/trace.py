"""The traced slice of a run: torch.profiler over the device's activity
alone, over whole epochs trained after the measured window, and its
reduction to busy time, kernel rows and idle gaps.

The profiler starts at an epoch's first step, where the program's own
read-back of the last epoch's losses has just waited for the device, so
its synchronise drains nothing; nothing inside the slice waits for the
device. Two marker kernels (`torch.cuda._sleep`, named `spin_kernel`) on
the training stream bound the slice on the device: the first, launched
right after that synchronise, has its device start put at the host's
clock reading before its launch, which puts every device timestamp on the
host's clock; the second follows the slice's last step. The profiler
slows the host's launches (and CUPTI stays attached once it has run), so
the slice comes after the window, whose steps stay untraced. A gap in the
device's work is labelled by the benchmark's own span (`feed.next`,
`train_step`, `kmeans`, `epoch_boundary`) that the host was in when the
gap began.
"""

from __future__ import annotations

import dataclasses
import re
import time

import torch


@dataclasses.dataclass
class Slice:
    kernels: list          # [(name, start_s, end_s)] on the host's clock
    start_s: float
    end_s: float
    steps: int

    @property
    def window_s(self) -> float:
        return self.end_s - self.start_s

    def busy_intervals(self) -> list:
        merged = []
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            a, b = max(a, self.start_s), min(b, self.end_s)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def gaps(self) -> list:
        """[(start_s, length_s)] of the device's idle time in the slice."""
        out, last = [], self.start_s
        for a, b in self.busy_intervals():
            if a > last:
                out.append((last, a - last))
            last = b
        if self.end_s > last:
            out.append((last, self.end_s - last))
        return out

    def matching(self, pattern: str) -> list:
        """The kernels whose name matches `pattern` (a regular expression)."""
        rx = re.compile(pattern)
        return [k for k in self.kernels if rx.search(k[0])]

    def seconds(self, pattern: str) -> float:
        return sum(b - a for _, a, b in self.matching(pattern))

    def rows(self) -> list:
        """[(name, count, seconds)] of every kernel and copy, longest first."""
        by = {}
        for name, a, b in self.kernels:
            n, s = by.get(name, (0, 0.0))
            by[name] = (n + 1, s + b - a)
        return sorted(((k, n, s) for k, (n, s) in by.items()),
                      key=lambda r: -r[2])


def label(t: float, spans: list, boundaries: list) -> str:
    """The span the host was in at `t`: one of `spans` [(name, a, b)], else
    `epoch_boundary` between an epoch's last step and the next's first
    (`boundaries` [(a, b)]), else `loop`."""
    for name, a, b in spans:
        if a <= t < b:
            return name
    for a, b in boundaries:
        if a <= t < b:
            return "epoch_boundary"
    return "loop"


MARKER = r"spin_kernel"
MARKER_CYCLES = 1000


class Tracer:
    """Profiles steps [first, last] (0-based, inclusive) of a run."""

    def __init__(self, first: int, last: int, device):
        self.first, self.last, self.device = first, last, device
        self.prof = None
        self.slice = None
        self.t_mark = None

    def before(self, k: int) -> None:
        if k != self.first:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)

    def after(self, k: int) -> None:
        if k != self.last or self.prof is None:
            return
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize(self.device)
        self.prof.stop()
        events = sorted(device_events(self.prof), key=lambda e: e[1])
        self.prof = None
        rx = re.compile(MARKER)
        marks = [e for e in events if rx.search(e[0])]
        if len(marks) != 2:
            raise RuntimeError(f"the traced slice found {len(marks)} of its "
                               "2 marker kernels")
        (_, a, _), (_, _, b) = marks

        def host(ns):
            return self.t_mark + (ns - a) * 1e-9

        kernels = [(n, host(x), host(y)) for n, x, y in events
                   if not rx.search(n) and a <= x < b]
        self.slice = Slice(kernels, host(a), host(b),
                           self.last - self.first + 1)


def device_events(prof) -> list:
    """[(name, start_ns, end_ns)] of the device's kernels, copies and
    fills, from the profiler's raw events."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def breakdown(sl: Slice, spans: list, boundaries: list) -> dict:
    """The 10 device operations that took most time, and the 10 longest
    idle gaps labelled by what the host was doing."""
    ops = [[name[:160], s] for name, _, s in sl.rows()[:10]]
    gaps = sorted(sl.gaps(), key=lambda g: -g[1])[:10]
    return {"device_ops": ops,
            "idle_gaps": [[label(a, spans, boundaries), length]
                          for a, length in gaps]}
