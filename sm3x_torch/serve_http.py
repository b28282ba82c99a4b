"""HTTP inference server over the bucketed `Predictor`
(sm3x_torch.serve): the port's own copy of sm3x/serve_http.py, which it
does not import. It needs the standard library's http.server and nothing
else, and is meant to run as a sidecar in front of one GPU:

* ``GET /healthz``  -> {"status": "ok", "labels": 8}
* ``GET /labels``   -> label names + per-label class counts
* ``POST /predict`` -> JSON {"cases": [{"derm": <b64 image>,
  "clinic": <b64 image>}, ...]} -> {"predictions": [{<label>:
  [class probabilities]}, ...]}. Images are JPEG/PNG bytes
  base64-encoded; any resolution (letterbox on the host, resize on the
  device).

Requests are served by a thread pool but device dispatch is serialized:
the batcher's one thread (or, with ``--no-batching``, one lock) replays one
bucket's CUDA graph at a time, so the GPU stays the only queue.

CLI: ``python -m sm3x_torch.serve_http --pretrain-path best_eval.pth``
(also installed as the ``sm3x-torch-serve`` console script), or
``--exported-path <dir>`` to serve an AOT artifact of
``sm3x_torch.export`` without the model code or the checkpoint.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from sm3x_torch import CLASSES_NAME, NUM_CLASSES


def _decode_image(b64: str) -> np.ndarray:
    """base64 JPEG/PNG bytes -> HxWx3 uint8 RGB array."""
    raw = base64.b64decode(b64)
    try:
        from PIL import Image

        img = Image.open(io.BytesIO(raw)).convert("RGB")
        return np.asarray(img, dtype=np.uint8)
    except ImportError:
        import cv2

        arr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        if arr is None:
            raise ValueError("undecodable image bytes")
        return arr[:, :, ::-1].copy()  # BGR -> RGB


class _Batcher:
    """Dynamic request batching: requests arriving within `max_wait_ms`
    coalesce into ONE bucketed device dispatch instead of serializing one
    dispatch per request — under concurrent load this multiplies
    throughput by the effective batch size (the coalesced batch is one
    replay of its bucket's graph)."""

    def __init__(self, predictor, max_batch: int = 32,
                 max_wait_ms: float = 5.0):
        self.predictor = predictor
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.q: queue.Queue = queue.Queue()
        self._stopped = False
        # guards the stopped-check + enqueue pair: without it a predict()
        # could pass the check, lose the CPU, and enqueue AFTER stop()
        # drained the queue — stranding its handler on done.wait() forever
        self._qlock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    _SENTINEL = object()

    def predict(self, derm, clinic):
        """Enqueue one request's images; blocks until its slice of the
        coalesced batch is ready. A dispatch failure fails every request
        of the affected batch (the tradeoff of coalescing); each caller
        gets a FRESH exception so concurrent re-raises don't share a
        traceback."""
        done = threading.Event()
        slot: dict = {}
        with self._qlock:
            if self._stopped:
                raise RuntimeError("batched dispatch failed: server stopping")
            # enqueued under the lock -> ordered BEFORE stop()'s sentinel,
            # so the loop either serves it or _fail_pending releases it
            self.q.put((derm, clinic, done, slot))
        done.wait()
        if "error" in slot:
            raise RuntimeError(f"batched dispatch failed: {slot['error']}")
        return slot["probs"]

    def stop(self):
        """Reject new requests, let the thread finish its current batch,
        then fail anything that raced the sentinel into the queue — no
        handler thread is left blocked on done.wait() forever."""
        with self._qlock:
            self._stopped = True
            self.q.put(self._SENTINEL)
        self._thread.join(timeout=30)
        self._fail_pending("server stopped")

    def _fail_pending(self, msg: str):
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                return
            if item is self._SENTINEL:
                continue
            _, _, done, slot = item
            slot["error"] = msg
            done.set()

    def _loop(self):
        while True:
            first = self.q.get()
            if first is self._SENTINEL:
                return
            batch = [first]
            n = len(first[0])
            deadline = time.monotonic() + self.max_wait
            while n < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is self._SENTINEL:
                    self.q.put(item)  # re-queue: stop after this batch
                    break
                batch.append(item)
                n += len(item[0])
            derm = [img for d, _, _, _ in batch for img in d]
            clinic = [img for _, c, _, _ in batch for img in c]
            try:
                probs = self.predictor.predict(derm, clinic)
                start = 0
                for d, _, done, slot in batch:
                    k = len(d)
                    slot["probs"] = [p[start:start + k] for p in probs]
                    start += k
                    done.set()
            except Exception as e:
                msg = f"{type(e).__name__}: {e}"
                for _, _, done, slot in batch:
                    slot["error"] = msg
                    done.set()


class PredictionServer:
    """Wrap a `sm3x_torch.serve.Predictor` in a threaded HTTP server.

    With ``batching=True`` (default) concurrent requests coalesce into
    single device dispatches via `_Batcher`; otherwise each request
    dispatches alone behind a lock."""

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 8000,
                 batching: bool = True, max_batch: int = 32,
                 max_wait_ms: float = 5.0, max_body_mb: float = 64.0):
        self.predictor = predictor
        max_body = int(max_body_mb * 1024 * 1024)
        self._lock = threading.Lock()  # serialize device dispatch
        self._batcher = (_Batcher(predictor, max_batch, max_wait_ms)
                         if batching else None)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet; callers have access logs
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok",
                                      "labels": len(CLASSES_NAME)})
                elif self.path == "/labels":
                    self._reply(200, {
                        "labels": list(CLASSES_NAME),
                        "num_classes": list(NUM_CLASSES)})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path != "/predict":
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length > max_body:
                    self._reply(413, {"error": f"request body {length} B "
                                               f"exceeds limit {max_body} B"})
                    return
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                    cases = req["cases"]
                    derm = [_decode_image(c["derm"]) for c in cases]
                    clinic = [_decode_image(c["clinic"]) for c in cases]
                except Exception as e:  # malformed request
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                try:
                    if server._batcher is not None:
                        probs = server._batcher.predict(derm, clinic)
                    else:
                        with server._lock:
                            probs = server.predictor.predict(derm, clinic)
                    out = [
                        {CLASSES_NAME[h]: probs[h][i].tolist()
                         for h in range(len(CLASSES_NAME))}
                        for i in range(len(cases))
                    ]
                    self._reply(200, {"predictions": out})
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        """Serve in a daemon thread (returns immediately)."""
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()  # no new requests; in-flight handlers finish
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._batcher is not None:
            self._batcher.stop()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("sm3x_torch HTTP inference server")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--pretrain-path", type=str,
                     help="best_eval.pth of an eval stage, or a released "
                          "best_linear / best_finetune .pth")
    src.add_argument("--exported-path", type=str,
                     help="AOT artifact directory from "
                          "sm3x_torch.export.export_predictor (serves "
                          "without model code or checkpoint)")
    p.add_argument("-a", "--arch", type=str, default="resnet50")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (a CUDA graph a bucket) or cpu (eager)")
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind address (loopback by default for the sidecar "
                        "use case; pass 0.0.0.0 to expose externally)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-body-mb", type=float, default=64.0,
                   help="reject /predict bodies larger than this with 413")
    p.add_argument("--test-sz", type=int, default=224)
    p.add_argument("--mean", nargs=3, type=float,
                   default=[0.7833, 0.6712, 0.6026])
    p.add_argument("--std", nargs=3, type=float,
                   default=[0.2139, 0.2472, 0.2571])
    p.add_argument("--buckets", nargs="*", type=int, default=[1, 8, 32, 128])
    p.add_argument("--crop-amount", type=int, default=25,
                   help="black-border crop applied to every request image "
                        "before letterbox (the training pipeline's "
                        "preprocessing; 0 disables)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="dynamic-batching coalesce limit (default: the "
                        "largest bucket, so every bucket's program is "
                        "reachable)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="dynamic-batching window")
    p.add_argument("--no-batching", action="store_true",
                   help="dispatch each request alone (lock-serialized)")
    args = p.parse_args(argv)

    if args.exported_path:
        from sm3x_torch.export import ExportedPredictor

        predictor = ExportedPredictor(args.exported_path, device=args.device)
        args.buckets = predictor.buckets
    else:
        from sm3x_torch.serve import Predictor

        predictor = Predictor.from_checkpoint(
            args.pretrain_path, arch=args.arch, mean=args.mean, std=args.std,
            test_sz=args.test_sz, buckets=tuple(args.buckets),
            crop_amount=args.crop_amount, device=args.device)
    if args.max_batch is None:
        # coalesce up to the largest warmed bucket: a smaller cap would
        # leave that bucket's program unreachable
        args.max_batch = max(args.buckets)
    # every bucket runs once before the socket opens: dynamic batching
    # coalesces bursts into the larger buckets, so the first request must
    # find each of them ready
    for b in sorted(set(args.buckets)):
        dummy = [np.zeros((64, 64, 3), np.uint8)] * b
        predictor.predict(dummy, dummy)
        print(f"warmed bucket {b}", flush=True)
    server = PredictionServer(predictor, args.host, args.port,
                              batching=not args.no_batching,
                              max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms,
                              max_body_mb=args.max_body_mb)
    print(f"serving on {args.host}:{server.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
