#!/usr/bin/env python
"""Several checkouts of the repo in turns on one NVIDIA GPU: for comparing
a parent commit with a change in one run on one card, where times
are comparable.

Each checkout is run in a process of its own, in the order given, so name
them parent, change, change, parent:

    git archive HEAD | tar -x -C build/parent        # build/ is ignored
    python tools/compare_checkouts_torch.py --phase vit build/parent . . build/parent

Phases: `main` and `vit` run the checkout's `chip_smoke.py` phase of that
name (four steps through SSLTrainer.fit, then the median of 8 timed steps,
peak memory, losses and launch counts; with `--profile DIR` also three
steps under torch.profiler, the table written to DIR/run<i>/). `k3f` builds
the checkout's kernels and times its bf16 flash-attention forward at
ViT-B's (64, 197, 12, 64): CUDA events around 200 launches in a row, three
times, with the relative Frobenius error against this checkout's plain
float32 forward. `k1k2` does the same for the photometric kernel K1 at
(96, 224, 224, 3) (the smoke run's inputs: every flag combination and op
order) and the NT-Xent forward K2f at (8, 96, 128), each with its largest
error against the checkout's plain version; beside the events' time a
launch (which holds the wrapper's host work where the kernel is short) it
prints the kernels' own time a call from torch.profiler and their names
and counts. Prints every run's lines under its checkout's name, then one
summary line a run.
"""

import argparse
import os
import re
import subprocess
import sys

_RUN = """
import sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as c
c.phase_device()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_{phase}({profile!r})
"""

_K3F = """
import sys, torch
sys.path.insert(0, {root!r})
from sm3x_torch.ops import attention as A, attention_cuda as K
torch.manual_seed(0)
q, k, v = (torch.randn(64, 197, 12, 64, device="cuda").bfloat16()
           for _ in range(3))
fwd = lambda: K.flash_forward_cuda(q, k, v, 0.125)
out, _ = fwd()
want, _ = A.attention_plain(q.float(), k.float(), v.float(), 0.125)
rel = float((out.float() - want).norm() / want.norm())
times = []
for _ in range(3):
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(200):
        fwd()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / 200)
print("K3f bf16 (64, 197, 12, 64) on", torch.cuda.get_device_name(0),
      "rel err vs float32 %.3e," % rel, "device ms a launch:",
      " ".join("%.4f" % t for t in times))
"""

_K1K2 = """
import sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as c
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from sm3x_torch.ops import augment_cuda as K, ntxent_cuda as N
torch.backends.cuda.matmul.allow_tf32 = False
torch.manual_seed(0)
images, params = c.k1_inputs()
z = torch.randn(8, 96, 128, device="cuda")
k1 = lambda: K.photometric_cuda(images, params, c.MEAN, c.STD)
k2f = lambda: N.ntxent_forward_cuda(z, 0.1)
err1 = float((k1() - K.photometric_plain(images, params, c.MEAN, c.STD))
             .abs().max())
err2 = max(float((a - b).abs().max()) for a, b in zip(
    k2f(), N.ntxent_forward_plain(z, 0.1)))

def events_ms(fn, n=200):
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return " ".join("%.4f" % t for t in times)

def profiled(fn, n=50):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    key = ("self_device_time_total" if hasattr(ev[0], "self_device_time_total")
           else "self_cuda_time_total")
    names = ", ".join("%s x%d" % (e.key.split("::")[-1].split("(")[0][:32],
                                  e.count // n) for e in ev)
    return "%.4f ms in [%s]" % (sum(getattr(e, key) for e in ev) / n / 1e3,
                                names)

print("K1 (96, 224, 224, 3) max abs err %.3e," % err1,
      "device ms a launch:", events_ms(k1) + ";", "kernels alone:",
      profiled(k1))
print("K2f (8, 96, 128) max abs err %.3e," % err2,
      "device ms a launch:", events_ms(k2f) + ";", "kernels alone:",
      profiled(k2f))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkouts", nargs="+",
                   help="roots of checkouts of the repo, in running order")
    p.add_argument("--phase", choices=("main", "vit", "k3f", "k1k2"),
                   default="vit")
    p.add_argument("--profile", metavar="DIR", default=None)
    args = p.parse_args(argv)
    summary = []
    for i, root in enumerate(args.checkouts):
        root = os.path.abspath(root)
        profile = None
        if args.profile:
            profile = os.path.join(os.path.abspath(args.profile), f"run{i}")
        code = {"k3f": _K3F, "k1k2": _K1K2}.get(args.phase, _RUN).format(
            root=root, phase=args.phase, profile=profile)
        res = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True)
        print(f"=== run {i}: {root}", flush=True)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], flush=True)
            return res.returncode
        if args.phase in ("k3f", "k1k2"):
            summary.extend(f"run {i} {root}: {ln}"
                           for ln in res.stdout.strip().splitlines())
            continue
        step = re.search(r"step time: median ([0-9.]+) ms.*?min ([0-9.]+)",
                         res.stdout)
        peak = re.search(r"peak device memory in fit: ([0-9.]+) GiB",
                         res.stdout)
        busy = re.search(r"device busy ([0-9.]+) ms per step", res.stdout)
        summary.append(f"run {i} {root}: step median {step.group(1)} ms, "
                       f"min {step.group(2)} ms, peak {peak.group(1)} GiB"
                       + (f", device busy {busy.group(1)} ms a step "
                          f"(profiled)" if busy else ""))
    print("\n".join(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
