"""Host ms a step inside the feed's next batch (the benchmark's `feed.next`
span around the port's feed), over the window's steps."""

UNIT = "ms"


def read(ctx):
    win = ctx["window"]
    spans = [b - a for name, a, b in ctx["spans"]
             if name == "feed.next" and a < win["end_s"]]
    return 1e3 * sum(spans) / win["steps"] if spans and win["steps"] else None
