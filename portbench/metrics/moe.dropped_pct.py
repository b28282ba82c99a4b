"""The share of the routing choices (k a token, each MoE block and encoder
call) of the window's first epochs (`stages/ssl_moe.py`'s `READ_EPOCHS`)
that the experts' capacity dropped, from the counts the trainer reads back
with each epoch's losses. Nothing where the cell routes no tokens."""

UNIT = "%"


def read(ctx):
    win = ctx["window"]
    choices = win.get("moe_assignments")
    if not choices:
        return None
    return 100.0 * win["moe_dropped"] / choices
