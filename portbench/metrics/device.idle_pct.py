"""The device's idle share at the untraced pace: 100 x (1 - busy / step),
busy being the traced slice's device time a step (the union of the
intervals in which a kernel, a copy or a fill ran, from torch.profiler's
device activity; the slice is whole epochs) and step the mean interval
between the CUDA events after the steps that the profiler does not touch.
The profiler slows the host's launches, so the slice's own idle share
(`busy_s` against `window_s`) reads higher."""

UNIT = "%"


def read(ctx):
    sl = ctx["slice"]
    return 100.0 * (1.0 - sl.busy_s / sl.steps / ctx["step_s"])
