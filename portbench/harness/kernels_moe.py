"""The yardstick of kernel K5 (the sparse-expert layer's token moves,
sm3x_torch/csrc/moe_dispatch.cu): each of its four kernels' least time
from a group's shapes (`shapes["moe"]` of a stage: N tokens, k choices, E
experts of C slots, width D) and the choices the capacity kept, by the
bytes it must move over the card's memory rate: each row it needs read
once and each row it makes written once, in bf16, int32 maps, float32
gates. Operations are a few a value, far under the bytes.

What a kernel needs depends on the routing: a dropped choice moves no row,
and an empty slot is written as zeros without a read. With K of the k N
choices kept, the tokens that keep one are at least K / k (each keeps at
most k), which this counts: a lower bound of the bytes, so that the share
it gives never reads above what the card could do."""

from __future__ import annotations

import math

from portbench.harness.kernels import BF16, F32, PEAK_BYTES_S

I32 = 4


def k5_bytes(n: int, k: int, experts: int, cap: int, d: int,
             kept=None) -> dict:
    """Bytes of one launch of each K5 kernel on one group; `kept` the
    choices the capacity kept (None: all k N)."""
    s = experts * cap
    kept = n * k if kept is None else kept
    tokens = math.ceil(kept / k)
    return {
        # the kept tokens' rows read, every slot written, slot_assign read
        "dispatch_fwd": (tokens + s) * d * BF16 + s * I32,
        # the kept slots' rows read, every token written, token_slot (N, k)
        # and the kept choices' gates read
        "combine_fwd": (kept + n) * d * BF16 + n * k * I32 + kept * F32,
        # dout of the kept tokens and the kept slots' rows read, every slot
        # of dy written; slot_assign read, the kept gates read and their
        # gradients written
        "combine_bwd": (tokens + kept + s) * d * BF16 + s * I32
                       + 2 * kept * F32,
        # the kept slots' gradients read, every token written, token_slot
        "dispatch_bwd": (kept + n) * d * BF16 + n * k * I32,
    }


def k5_bounds_s(n: int, k: int, experts: int, cap: int, d: int,
                kept=None) -> dict:
    return {kind: b / PEAK_BYTES_S
            for kind, b in k5_bytes(n, k, experts, cap, d, kept).items()}
