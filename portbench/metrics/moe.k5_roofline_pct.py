"""K5 (the sparse-expert layer's token moves, csrc/moe_dispatch.cu: dispatch
and combine, forward and backward) against its roofline: the least time of
each launch by the group's shapes and the share of choices the traced
epochs kept (`harness/kernels_moe.py`, bytes bound), summed over the four
kernels, over their summed device time. Nothing where the cell routes no
tokens."""

from portbench.harness.kernels_moe import k5_bounds_s

KINDS = {"dispatch_fwd": r"moe_dispatch_fwd_kernel",
         "combine_fwd": r"moe_combine_fwd_kernel",
         "combine_bwd": r"moe_combine_bwd_kernel",
         "dispatch_bwd": r"moe_dispatch_bwd_kernel"}
UNIT = "%"


def read(ctx):
    shape = ctx["shapes"].get("moe")
    if not shape:
        return None
    win = ctx["window"]
    choices = shape["n"] * shape["k"]
    kept = choices
    if win.get("moe_traced_assignments"):
        kept = choices * (1.0 - win["moe_traced_dropped"]
                          / win["moe_traced_assignments"])
    bounds = k5_bounds_s(shape["n"], shape["k"], shape["experts"],
                         shape["cap"], shape["d"], kept)
    sl = ctx["slice"]
    bound = busy = 0.0
    for kind, pattern in KINDS.items():
        launches = sl.matching(pattern)
        bound += bounds[kind] * len(launches)
        busy += sum(b - a for _, a, b in launches)
    return 100.0 * bound / busy if busy > 0 else None
