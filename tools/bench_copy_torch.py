#!/usr/bin/env python
"""Device-memory streaming rate of one NVIDIA GPU: the port's identity-copy
kernel K4 (sm3x_torch/csrc/copy.cu) against a PyTorch elementwise op over
the same float32 array.

Counterpart of tools/bench_pallas_io.py (the TPU's Pallas copy against an
XLA elementwise op), with its JSON lines: each pass runs `iters` chained
iterations (every output is the next input), timed with CUDA events after
a warm-up, and counts one read and one write of the array per iteration.
The copy's result is checked to equal its input exactly.

Usage: python tools/bench_copy_torch.py [mib] [iters]     (default 256 50)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chain(fn, x, iters):
    for _ in range(iters):
        x = fn(x)
    return x


def main(argv=None):
    import torch

    from sm3x_torch.ops import copy_cuda

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("bench_copy_torch: needs an NVIDIA GPU "
                         "(torch.cuda.is_available() is false)")
    mib = int(argv[0]) if len(argv) > 0 else 256
    iters = int(argv[1]) if len(argv) > 1 else 50

    rows = mib * 1024 * 1024 // (4 * 1024)  # f32, 1024-wide
    x = torch.randn(rows, 1024, device="cuda")
    nbytes = x.numel() * 4
    results = {}
    for name, fn in (("cuda_copy_kernel", copy_cuda.copy_cuda),
                     ("torch_elementwise", lambda v: v + 1.0)):
        out = _chain(fn, x, 2)  # warm-up: build, allocator
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = _chain(fn, x, iters)
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
        if name == "cuda_copy_kernel" and not torch.equal(out, x):
            raise AssertionError("the copy kernel's output differs from its "
                                 "input")
        gbps = 2 * nbytes * iters / secs / 1e9  # read + write per iteration
        results[name] = gbps
        print(json.dumps({"metric": f"{name}_gbytes_per_sec",
                          "value": round(gbps, 1),
                          "unit": f"GB/s ({mib} MiB array, {iters} chained "
                                  f"iterations, "
                                  f"{torch.cuda.get_device_name(0)})"}),
              flush=True)
    return results


if __name__ == "__main__":
    main()
