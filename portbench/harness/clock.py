"""The arithmetic of the end-to-end metrics, on plain numbers: the rate over
the whole window and the 90th percentile of the step intervals."""

from __future__ import annotations

import statistics


def rate(cases: int, window_s: float) -> float:
    """Cases trained over the window's wall time (all work, all time)."""
    return cases / window_s


def intervals_ms(step_ends_ms, start_ms: float = 0.0) -> list:
    """Intervals between consecutive step ends, the first from the window's
    start: each holds whatever the device waited for in that step."""
    out, last = [], start_ms
    for t in step_ends_ms:
        out.append(t - last)
        last = t
    return out


def p90(values) -> float:
    """The 90th percentile (inclusive quantiles: between sample values,
    never past the largest)."""
    return statistics.quantiles(values, n=10, method="inclusive")[8]

