"""K1 (the photometric chain, csrc/photometric.cu) against its roofline:
the least time of each launch by its shape (bytes bound), summed, over the
launches' device time. The shapes are the cell's views; nothing where no
K1 ran."""

from portbench.harness.kernels import k1_bound_s

K1 = r"photometric_(?:band|scratch)_kernel"
UNIT = "%"


def read(ctx):
    launches = ctx["slice"].matching(K1)
    shapes = ctx["shapes"]["k1"]
    if not launches or not shapes:
        return None
    mean_bound = sum(k1_bound_s(*s) for s in shapes) / len(shapes)
    busy = sum(b - a for _, a, b in launches)
    return 100.0 * mean_bound * len(launches) / busy
