"""Tracing / profiling / numeric-debug hooks (counterpart of
sm3x/utils/profiling.py; the port's own code).

The reference has only wall-clock AverageMeters (backbone_train.py:71-72)
and TORCH_DISTRIBUTED_DEBUG as its lone concurrency diagnostic (run.sh:3).
Here:

* `trace` — context manager around torch.profiler: host ops, and the
  card's kernels and copies where there is one, written as a trace under
  a log dir (view in TensorBoard's profiler plugin or Perfetto);
* `annotate` — a named region (torch.profiler.record_function) for step
  phases;
* `StepTimer` — data/compute wall-clock split, the batch_time/data_time
  meter pair;
* `check_finite` — a NaN/Inf report on a nested structure of tensors;
  `enable_nan_checks` is the switch that raises at the first operator
  that makes a NaN, forward or backward (the JAX package's
  `jax_debug_nans`).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str, with_memory: bool = True):
    """Profile the enclosed block (CPU activity, plus CUDA with a card) and
    write its trace under `log_dir` (`*.pt.trace.json`)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, profile_memory=with_memory,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named region inside a trace (shows up on the profiler's timeline)."""
    return torch.profiler.record_function(name)


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
