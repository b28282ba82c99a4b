#!/usr/bin/env python
"""HTTP serving soak of the PyTorch port at the released model's shape (the
twin of tools/bench_serve_soak.py).

    python tools/bench_serve_soak_torch.py [--requests 200] [--clients 16]

Builds the released architecture with random weights from seed 0 (dual
ResNet-50 at 224, mlc_proj_dim 512, sa_dim_ff 128, the eight heads), wraps
it in `sm3x_torch.serve.Predictor` (a CUDA graph a bucket, buckets 1, 4,
8 and 16; eager on the CPU) and `sm3x_torch.serve_http.PredictionServer`
on the loopback with the batcher on (max batch 16, 20 ms wait), then runs
the reference's protocol. Each request is one case, two random 400-600
pixel images sent as base64 JPEGs:
  burst  `--burst` requests at once through the batcher, against the same
         requests one after another
  soak   `--requests` requests from `--clients` threads
Every bucket and the HTTP path are warmed before any timing.

Prints one JSON line: the reference's keys (`metric`
serve_soak_cases_per_sec, `value` the soak's cases a second,
`burst_coalesced_ms`, `burst_serialized_ms`, `coalescing_ratio`, the shape
and the counts), the soak's request latency at the 50th and 99th
percentile, and `device`: the card's name and power limit as nvidia-smi
gives them, or "cpu".
"""

import argparse
import base64
import concurrent.futures
import io
import json
import os
import sys
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

BUCKETS = (1, 4, 8, 16)
MEAN = (0.7833, 0.6712, 0.6026)   # run.sh's Derm7pt statistics
STD = (0.2139, 0.2472, 0.2571)


def _b64_jpeg(img: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--test-sz", type=int, default=224)
    p.add_argument("--canvas", type=int, default=320)
    p.add_argument("--mlc-proj-dim", type=int, default=512)
    p.add_argument("--sa-dim-ff", type=int, default=128)
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--burst", type=int, default=8)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("bench_serve_soak_torch: torch.cuda.is_available() "
                         "is false; --device cpu only checks the script")
    from sm3x_torch.api import build_evaluator
    from sm3x_torch.serve import Predictor
    from sm3x_torch.serve_http import PredictionServer
    from sm3x_torch.utils.timing import nvidia_smi_name_and_limit

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_evaluator(arch=args.arch,
                                mlc_proj_dim=args.mlc_proj_dim,
                                sa_dim_ff=args.sa_dim_ff,
                                img_size=args.test_sz)
    predictor = Predictor(model.to(args.device), MEAN, STD,
                          test_sz=args.test_sz, canvas=args.canvas,
                          buckets=BUCKETS)

    rng = np.random.default_rng(0)

    def img():
        h, w = rng.integers(400, 600), rng.integers(400, 600)
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    for b in BUCKETS:   # every bucket once before any timing
        predictor.predict([img() for _ in range(b)],
                          [img() for _ in range(b)])

    server = PredictionServer(predictor, host="127.0.0.1", port=0,
                              batching=True, max_batch=max(BUCKETS),
                              max_wait_ms=20).start()
    url = f"http://127.0.0.1:{server.port}/predict"

    def one_request(_):
        body = json.dumps({"cases": [
            {"derm": _b64_jpeg(img()), "clinic": _b64_jpeg(img())}]}).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            json.load(r)["predictions"]
        return (time.perf_counter() - t) * 1e3

    try:
        one_request(0)  # the HTTP path's warm-up
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(args.burst) as ex:
            list(ex.map(one_request, range(args.burst)))
        burst_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for i in range(args.burst):
            one_request(i)
        serial_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(args.clients) as ex:
            latencies = list(ex.map(one_request, range(args.requests)))
        soak_s = time.perf_counter() - t0
    finally:
        server.stop()

    out = {
        "metric": "serve_soak_cases_per_sec",
        "arch": args.arch, "test_sz": args.test_sz,
        "mlc_proj_dim": args.mlc_proj_dim, "sa_dim_ff": args.sa_dim_ff,
        "value": args.requests / soak_s,
        "requests": args.requests, "clients": args.clients,
        "burst_n": args.burst,
        "burst_coalesced_ms": burst_ms,
        "burst_serialized_ms": serial_ms,
        "coalescing_ratio": serial_ms / burst_ms,
        "latency_ms_p50": float(np.percentile(latencies, 50)),
        "latency_ms_p99": float(np.percentile(latencies, 99)),
        "buckets": list(BUCKETS),
        "device": (nvidia_smi_name_and_limit() if args.device != "cpu"
                   else "cpu"),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
