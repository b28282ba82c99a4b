"""Tracing / profiling / numeric-debug hooks (counterpart of
sm3x/utils/profiling.py; the port's own code).

The reference has only wall-clock AverageMeters (backbone_train.py:71-72)
and TORCH_DISTRIBUTED_DEBUG as its lone concurrency diagnostic (run.sh:3).
Here:

* `trace` — context manager around torch.profiler: host ops, and the
  card's kernels and copies where there is one, written as a trace under
  a log dir (view in TensorBoard's profiler plugin or Perfetto);
* `annotate` — a named region of a step's phase: a no-op unless turned
  on, a `record_function` on the timeline under `trace`, and a span in
  memory while `record` is on; `count` is its counter beside it, and
  `take` reads both out;
* `StepTimer` — data/compute wall-clock split, the batch_time/data_time
  meter pair;
* `check_finite` — a NaN/Inf report on a nested structure of tensors;
  `enable_nan_checks` is the switch that raises at the first operator
  that makes a NaN, forward or backward (the JAX package's
  `jax_debug_nans`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str, with_memory: bool = True):
    """Profile the enclosed block (CPU activity, plus CUDA with a card) and
    write its trace under `log_dir` (`*.pt.trace.json`); inside it each
    `annotate` region is on the profiler's timeline."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    global _TRACING
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was, _TRACING = _TRACING, True
    _rewire()
    try:
        with profile(activities=activities, profile_memory=with_memory,
                     on_trace_ready=tensorboard_trace_handler(log_dir)):
            yield
    finally:
        _TRACING = was
        _rewire()


# --- spans and counters -------------------------------------------------
#
# Off (the default) `annotate` costs one read of `_OPEN` and returns the
# shared `_NOOP`; `count` one read of `_RECORDING`. The clock of a span is
# time.perf_counter_ns(), the host clock onto which a profiler's device
# timestamps can be mapped (a marker kernel launched at a known reading).

SPAN_CAP = 1 << 18  # spans kept between two `take`s; later ones are dropped


class Span(NamedTuple):
    """One `annotate` region. `parent` is the index of the span that held
    it on the same thread (-1 for none) and `root` that of the outermost
    one (its own index for a root): all of a step's spans share the step's
    `root`. `end_ns` is 0 while it is open; `cpu_ns` is the thread's CPU
    time (time.thread_time_ns) at a root's start and end, else None."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int
    thread: int
    cpu_ns: tuple | None


class Recording(NamedTuple):
    spans: list        # [Span] in the order they opened
    counters: dict     # {name: total}
    dropped: int       # spans past SPAN_CAP


class _Open(threading.local):
    def __init__(self):
        self.stack = []    # (rows, index, root) of this thread's open spans


class _Store:
    """What `record` keeps: span rows and counters, shared by threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.open = _Open()
        self.rows, self.counters, self.dropped = [], {}, 0

    def take(self) -> Recording:
        with self.lock:
            rows, counters, dropped = self.rows, self.counters, self.dropped
            self.rows, self.counters, self.dropped = [], {}, 0
        spans = [Span(r[0], r[1], r[2], r[3], r[4], r[5],
                      None if r[6] is None else (r[6], r[7])) for r in rows]
        return Recording(spans, counters, dropped)


class _Span:
    """A span of `_STORE`, and its `record_function` under `trace`."""

    __slots__ = ("name", "row", "region")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        store = _STORE
        stack = store.open.stack
        top = stack[-1] if stack else None
        with store.lock:
            rows = store.rows
            i = len(rows) if len(rows) < SPAN_CAP else -1
            # a root, unless its parent is in this read-out
            parent, root = ((top[1], top[2]) if top is not None
                            and top[0] is rows else (-1, i))
            # [name, start, end, parent, root, thread, cpu start, cpu end]
            row = [self.name, 0, 0, parent, root, threading.get_ident(),
                   None, None]
            if i < 0:
                store.dropped += 1
            else:
                rows.append(row)
        if parent < 0:
            row[6] = time.thread_time_ns()
        stack.append((rows, i, root))
        self.row = row
        self.region = None
        if _TRACING:
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        row[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        row = self.row
        row[2] = time.perf_counter_ns()
        if row[6] is not None:
            row[7] = time.thread_time_ns()
        if self.region is not None:
            self.region.__exit__(*exc)
        _STORE.open.stack.pop()
        return False


_NOOP = contextlib.nullcontext()
_STORE = _Store()
_RECORDING = False
_TRACING = False
_OPEN = None   # what `annotate` opens; None: nothing


def _rewire() -> None:
    global _OPEN
    _OPEN = (_Span if _RECORDING else
             torch.profiler.record_function if _TRACING else None)


def annotate(name: str):
    """A named region of a step's phase: the shared no-op unless `record`
    is on (a span in memory) or `trace` runs (a region on its timeline)."""
    opener = _OPEN
    return _NOOP if opener is None else opener(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while `record` is on."""
    if not _RECORDING:
        return
    with _STORE.lock:
        _STORE.counters[name] = _STORE.counters.get(name, 0) + n


def record(on: bool = True) -> None:
    """Turn the recording of spans and counters on or off, in every thread
    of the process; what was recorded stays until `take`."""
    global _RECORDING
    _RECORDING = bool(on)
    _rewire()


def take() -> Recording:
    """The spans and counters recorded since the last `take`, cleared. A
    span still open is returned with `end_ns` 0, and a span opened inside
    it afterwards becomes a root."""
    return _STORE.take()


# factories whose output is memory nobody has written yet: a NaN there is
# not a value that any computation made
_UNWRITTEN = {torch.ops.aten.empty, torch.ops.aten.empty_like,
              torch.ops.aten.empty_strided, torch.ops.aten.empty_permuted,
              torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
              torch.ops.aten.resize_}


class _NanCheck(TorchDispatchMode):
    """Raises FloatingPointError where an ATen operator returns a floating
    tensor holding a NaN. Views (which compute nothing) and the factories
    of unwritten memory are not checked; infinities pass."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.is_view or func.overloadpacket in _UNWRITTEN
                or (torch.cuda.is_initialized()
                    and torch.cuda.is_current_stream_capturing())):
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


_NAN_CHECK = None


def enable_nan_checks(enable: bool = True):
    """Raise FloatingPointError at the first operator that makes a NaN, as
    `jax_debug_nans` does: every floating output of every ATen operator is
    checked, in forward and backward passes, and anomaly mode is on beside
    it for the forward's stack trace. Infinities pass. `False` turns both
    off; calling either twice is harmless.

    The check covers the thread that turned it on and the backward passes
    that thread starts (autograd's engine runs them under the caller's
    thread-local state); `jax_debug_nans` covers the whole process. Each
    check reads a flag back to the host, so no check runs while a CUDA
    graph is captured (serve.Predictor's), and a graph's replays are not
    checked. The kernels' own launches are not ATen operators: a NaN they
    make is caught at the next operator that reads it."""
    global _NAN_CHECK
    if enable and _NAN_CHECK is None:
        _NAN_CHECK = _NanCheck()
        _NAN_CHECK.__enter__()
    elif not enable and _NAN_CHECK is not None:
        _NAN_CHECK.__exit__(None, None, None)
        _NAN_CHECK = None
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree, path=()):
    if isinstance(tree, dict):  # in key order, as a JAX pytree's
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    else:
        yield "".join(path), tree


def check_finite(tree, name: str = "tree"):
    """Print the count of non-finite values of each floating tensor leaf of
    `tree` (nested dicts, lists and tuples) that has any, and return the
    tree unchanged. One host sync a call (the JAX version prints from
    inside the graph): leave it in debugging runs only."""
    for path, x in _leaves(tree):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            continue
        bad = int(x.numel() - torch.isfinite(x).sum())
        if bad > 0:
            print(f"NON-FINITE in {name} at {path}: {bad} bad values")
    return tree


class StepTimer:
    """batch_time / data_time split meter (reference ssl_train meters)."""

    def __init__(self):
        self.data_time = 0.0
        self.step_time = 0.0
        self.count = 0
        self._mark = time.perf_counter()

    def data_ready(self):
        now = time.perf_counter()
        self.data_time += now - self._mark
        self._mark = now

    def step_done(self):
        now = time.perf_counter()
        self.step_time += now - self._mark
        self._mark = now
        self.count += 1

    def summary(self) -> dict:
        n = max(self.count, 1)
        return {"data_time": self.data_time / n, "step_time": self.step_time / n}
