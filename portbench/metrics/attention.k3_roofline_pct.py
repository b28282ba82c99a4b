"""K3 (flash attention: K3f, K3b-dq, K3b-dkv, csrc/flash_attention*.cu)
against its roofline: the least time of each launch by its shape, summed
over the three kernels, over their summed device time. Nothing where the
cell runs no K3."""

from portbench.harness.kernels import k3_bounds_s

KINDS = {"fwd": r"(?:^|::)(?:flash_)?fwd_kernel\b",
         "dq": r"(?:^|::)(?:flash_)?bwd_dq_kernel\b",
         "dkv": r"(?:^|::)(?:flash_)?bwd_dkv_kernel\b"}
UNIT = "%"


def read(ctx):
    shapes = ctx["shapes"]["k3"]
    if not shapes:
        return None
    sl = ctx["slice"]
    bounds = [k3_bounds_s(*s) for s in shapes]
    bound = busy = 0.0
    for kind, pattern in KINDS.items():
        launches = sl.matching(pattern)
        mean = sum(b[kind] for b in bounds) / len(bounds)
        bound += mean * len(launches)
        busy += sum(b - a for _, a, b in launches)
    return 100.0 * bound / busy if busy > 0 else None
