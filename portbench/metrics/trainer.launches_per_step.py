"""Kernels, copies and fills on the device a step of the traced slice, the
host's launches that the trainer loops drive (the slice's markers left
out)."""

UNIT = "launches"


def read(ctx):
    sl = ctx["slice"]
    return len(sl.kernels) / sl.steps
