"""The whole step's share of the card's dense peak in the precision of the
cell's matmuls (the configuration's `matmul_precision`): the model's
operations a step (forward and backward, from the shapes by the
configuration's own function; recompute not counted) over the mean
interval between the CUDA events after the steps that the profiler does
not touch."""

from portbench.harness.kernels import PEAK_FLOPS

UNIT = "%"


def read(ctx):
    peak = PEAK_FLOPS[ctx["cell"].config["matmul_precision"]]
    return 100.0 * ctx["shapes"]["flops"] / ctx["step_s"] / peak
