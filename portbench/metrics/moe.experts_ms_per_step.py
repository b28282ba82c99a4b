"""Device ms a step in the expert layers: from each K5 dispatch-forward
launch's start to the end of the next combine-forward (the forward's
dispatch, expert products and combine), and from each combine-backward's
start to the end of the next dispatch-backward (the same backward), over
the traced slice's steps. Nothing where no K5 kernel ran."""

UNIT = "ms"

SPANS = ((r"moe_dispatch_fwd_kernel", r"moe_combine_fwd_kernel"),
         (r"moe_combine_bwd_kernel", r"moe_dispatch_bwd_kernel"))


def read(ctx):
    sl = ctx["slice"]
    total, found = 0.0, False
    for first, last in SPANS:
        ends = sorted(b for _, _, b in sl.matching(last))
        for _, a, _ in sorted(sl.matching(first), key=lambda k: k[1]):
            end = next((b for b in ends if b > a), None)
            if end is not None:
                total += end - a
                found = True
    return 1e3 * total / sl.steps if found else None
