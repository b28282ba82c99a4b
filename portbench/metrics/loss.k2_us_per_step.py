"""Device us a step in K2f and K2b (NT-Xent, csrc/ntxent.cu); nothing where
neither ran."""

K2 = r"ntxent_(?:fwd|bwd)_kernel"
UNIT = "us"


def read(ctx):
    sl = ctx["slice"]
    seconds = sl.seconds(K2)
    return 1e6 * seconds / sl.steps if seconds > 0 else None
