"""The yardstick of the kernels: the table of peaks of one NVIDIA H100 SXM
(NVIDIA's data sheet, dense, at its 700 W limit), and each hand-written
kernel's least time from its shapes: the larger of the bytes it must move
(each input read once, each output written once) over the memory rate and
its operations over the peak rate of their type."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "float32": 67e12}

F32, BF16 = 4, 2
K3_STATS = F32      # the per-row logsumexp (and delta) of a (B, H, S) grid


def bound_s(nbytes: float, flops: float, kind: str) -> float:
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[kind])


def k1_bound_s(images: int, h: int, w: int) -> float:
    """K1, the photometric chain: (B, H, W, 3) float32 in, the (B, 16)
    parameters, (B, H, W, 3) float32 out; 130 operations a pixel."""
    pixels = images * h * w
    return bound_s(2 * pixels * 3 * F32 + images * 16 * F32, 130 * pixels,
                   "float32")


def k3_bounds_s(b: int, s: int, h: int, d: int) -> dict:
    """K3f, K3b-dq and K3b-dkv in bf16 at q, k, v of (B, S, H, D): the
    forward reads q, k, v and writes the output and the logsumexp; dq
    reads q, k, v, the output, its gradient and the logsumexp, writes dq
    and delta; dkv reads q, k, v, the output's gradient, the logsumexp and
    delta, writes dk and dv. One (S, S, D) product a (b, h) is 2 b h S^2 D
    operations: the forward makes two, dq three, dkv four."""
    t = b * s * h * d * BF16
    stats = b * h * s * K3_STATS
    qk = 2 * b * h * s * s * d
    return {"fwd": bound_s(4 * t + stats, 2 * qk, "bf16"),
            "dq": bound_s(6 * t + 2 * stats, 3 * qk, "bf16"),
            "dkv": bound_s(6 * t + 2 * stats, 4 * qk, "bf16")}
