"""Batched inference serving (counterpart of sm3x/serve.py; the port's own
code, it imports nothing of the JAX package).

A `Predictor`:

* keeps one program a batch bucket and pads a request up to the bucket, so
  an odd request size costs no new program;
* takes raw uint8 RGB images (any aspect) and applies the preprocessing
  every training and eval image received: the 25-px black border crop, then
  letterbox, with resize and normalise on the device;
* returns per-label softmax probabilities, (B, C_i) a head.

On a CUDA device a bucket's program is one CUDA graph, captured after a
warm-up over static input buffers (two (b, canvas, canvas, 3) uint8 canvases
and two (b, 2) int32 sizes) with one static output. The graphs share one
memory pool and the largest bucket is captured first, so together they hold
about what the largest needs. The eight heads leave the device as one packed
(b, sum C_i) float32 tensor in one transfer, softmax inside the graph. The
graph is the only path there: a capture that fails raises. The encoders
run under bf16 autocast where the model was built with `amp` (the default of
`sm3x_torch.api.build_evaluator`, as the JAX package serves in bf16); the
head, the softmax and a model built with `amp=False` run in float32 with
TF32 off, at capture and so at every replay. Autocast's cache of cast
weights is off in the forward, so no cast made in a warm-up outlives it
into a capture: each graph holds its own casts.

On the CPU (`device="cpu"`, the tests) the same forward runs eagerly under
`inference_mode`; there is no graph.

`BucketedPredictor` is the request surface (crop, letterbox, bucket, pad,
chunk, trim); `Predictor` adds the model.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
from typing import Sequence

import numpy as np
import torch

from sm3x_torch import NUM_CLASSES
from sm3x_torch.data.pipeline import letterbox
from sm3x_torch.ops.augment import eval_resize_batch

FIELDS = ("derm", "derm_hw", "clinic", "clinic_hw")


def crop_border(img: np.ndarray, crop_amount: int) -> np.ndarray:
    """The training pipeline's black-border crop (decode_canvas_batch):
    crop only when a non-empty interior remains."""
    if (crop_amount > 0 and img.shape[0] > 2 * crop_amount
            and img.shape[1] > 2 * crop_amount):
        return img[crop_amount:-crop_amount, crop_amount:-crop_amount]
    return img


class BucketedPredictor:
    """The serving request surface: border-crop and letterbox raw images
    into canvases, pick the smallest bucket that fits, pad up to it, chunk
    oversize requests through the largest bucket (before any canvas work),
    trim the padding off the outputs.

    Subclasses set `buckets`, `canvas`, `crop_amount`, `num_classes` and
    implement `_call(b, derm, derm_hw, clinic, clinic_hw)`, which returns
    the per-label probability arrays for bucket `b`."""

    buckets: Sequence[int]
    canvas: int
    crop_amount: int = 25
    num_classes: Sequence[int] = tuple(NUM_CLASSES)

    def _call(self, b: int, derm, derm_hw, clinic, clinic_hw):
        raise NotImplementedError

    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[min(i, len(self.buckets) - 1)]

    def _canvases(self, images) -> tuple:
        """images: list of HxWx3 uint8 arrays (any sizes) -> canvases and
        valid sizes, through the training pipeline's crop-then-letterbox."""
        n = len(images)
        canv = np.zeros((n, self.canvas, self.canvas, 3), np.uint8)
        hw = np.zeros((n, 2), np.int32)
        for i, img in enumerate(images):
            img = crop_border(np.asarray(img)[:, :, :3], self.crop_amount)
            canv[i], (h, w) = letterbox(img, self.canvas)
            hw[i] = (h, w)
        return canv, hw

    def predict(self, derm_images, clinic_images):
        """Lists of uint8 RGB arrays -> list of 8 (B, C_i) probability
        arrays (padding trimmed; oversize requests chunked through the
        largest bucket)."""
        assert len(derm_images) == len(clinic_images)
        n = len(derm_images)
        if n == 0:
            return [np.zeros((0, c), np.float32) for c in self.num_classes]
        b = self._bucket(n)
        if n > b:  # chunk before letterboxing anything
            outs = None
            for s in range(0, n, b):
                part = self.predict(derm_images[s:s + b],
                                    clinic_images[s:s + b])
                outs = part if outs is None else [
                    np.concatenate([a, c]) for a, c in zip(outs, part)]
            return outs
        dc, dhw = self._canvases(derm_images)
        cc, chw = self._canvases(clinic_images)

        def pad(x):
            reps = [(0, b - n)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, reps, mode="edge") if n < b else x

        preds = self._call(b, pad(dc), pad(dhw), pad(cc), pad(chw))
        return [np.asarray(p)[:n] for p in preds]


def _no_autocast_cache(device: torch.device):
    """Autocast's weight-cast cache off for everything inside: an autocast
    region opened within (the encoders') inherits the setting. Autocast
    itself stays off here, so the head runs in float32."""
    return torch.autocast(device.type, enabled=False, cache_enabled=False)


@contextlib.contextmanager
def _tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class _BucketGraph:
    """One bucket on the card: static device inputs, the pinned host
    buffers they are filled from, the captured graph, its static output and
    the pinned buffer the output comes back in."""

    def __init__(self, predictor: "Predictor", b: int, pool):
        dev, s = predictor.device, predictor.canvas
        shapes = {"derm": ((b, s, s, 3), torch.uint8),
                  "derm_hw": ((b, 2), torch.int32),
                  "clinic": ((b, s, s, 3), torch.uint8),
                  "clinic_hw": ((b, 2), torch.int32)}
        self.static = {k: torch.zeros(shape, dtype=dt, device=dev)
                       for k, (shape, dt) in shapes.items()}
        for k in ("derm_hw", "clinic_hw"):
            self.static[k].fill_(s)  # a whole canvas, for the warm-up
        self.pinned = {k: torch.zeros(shape, dtype=dt, pin_memory=True)
                       for k, (shape, dt) in shapes.items()}
        args = [self.static[k] for k in FIELDS]
        # warm-up on a side stream, the same (bf16 or float32) forward as
        # the capture's: lazy initialisation and cuDNN's choice of
        # algorithms must not fall into the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                predictor._forward(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = predictor._forward(*args)
        self.host_out = torch.zeros(self.out.shape, dtype=self.out.dtype,
                                    pin_memory=True)


class Predictor(BucketedPredictor):
    """Serving wrapper around an `MLCModel` with its weights loaded, on the
    device the weights are on."""

    def __init__(self, model, mean, std, test_sz: int = 224,
                 buckets: Sequence[int] = (1, 8, 32, 128),
                 canvas: int = 320, crop_amount: int = 25):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.test_sz = test_sz
        self.buckets = sorted(buckets)
        self.canvas = canvas
        self.crop_amount = crop_amount
        # made once, on the device: a capturing stream takes no copy from
        # pageable host memory
        self.mean = torch.tensor(tuple(mean), dtype=torch.float32,
                                 device=self.device)
        self.std = torch.tensor(tuple(std), dtype=torch.float32,
                                device=self.device)
        # one dispatch at a time: the static buffers are shared
        self._lock = threading.Lock()
        self._graphs = {}
        if self.device.type == "cuda":
            self._capture()

    def _forward(self, derm, derm_hw, clinic, clinic_hw) -> torch.Tensor:
        """Canvases and sizes on the device -> the packed (b, sum C_i)
        float32 probabilities."""
        size = (self.test_sz, self.test_sz)
        with (torch.inference_mode(), _tf32_off(),
              _no_autocast_cache(self.device)):
            d = eval_resize_batch(derm, derm_hw, self.mean, self.std, size)
            c = eval_resize_batch(clinic, clinic_hw, self.mean, self.std,
                                  size)
            _, preds = self.model(d, c)
            return torch.cat([torch.softmax(p.float(), dim=-1)
                              for p in preds], dim=-1)

    def _capture(self) -> None:
        """One CUDA graph a bucket, the largest first, in one memory pool.
        The memory the warm-ups left cached is given back afterwards."""
        torch.cuda.set_device(self.device)
        self._stream = torch.cuda.Stream(self.device)
        self._pool = torch.cuda.graph_pool_handle()
        for b in sorted(set(self.buckets), reverse=True):
            self._graphs[b] = _BucketGraph(self, b, self._pool)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()

    @classmethod
    def from_checkpoint(cls, pretrain_path: str, arch: str = "resnet50",
                        mean=(0.7833, 0.6712, 0.6026),
                        std=(0.2139, 0.2472, 0.2571),
                        mlc_proj_dim: int = 512, sa_dim_ff: int = 128,
                        num_labels: int = 8, device="cuda", **kw):
        from sm3x_torch.api import build_evaluator, load_weights

        model = build_evaluator(arch=arch, mlc_proj_dim=mlc_proj_dim,
                                num_labels=num_labels, sa_dim_ff=sa_dim_ff)
        load_weights(model, pretrain_path, device=device)
        return cls(model, mean, std, **kw)

    def _replay(self, b: int, arrays) -> np.ndarray:
        """Fill bucket `b`'s static inputs, replay its graph and fetch the
        packed output: the uploads, the replay and the one transfer back
        are queued on one stream."""
        torch.cuda.set_device(self.device)  # the caller's thread
        g = self._graphs[b]
        with torch.cuda.stream(self._stream):
            for k, arr in zip(FIELDS, arrays):
                np.copyto(g.pinned[k].numpy(), arr)
                g.static[k].copy_(g.pinned[k], non_blocking=True)
            g.graph.replay()
            g.host_out.copy_(g.out, non_blocking=True)
        self._stream.synchronize()
        return g.host_out.numpy().copy()

    def _call(self, b, derm, derm_hw, clinic, clinic_hw):
        arrays = (derm, derm_hw, clinic, clinic_hw)
        with self._lock:
            if self.device.type == "cuda":
                packed = self._replay(b, arrays)
            else:
                packed = self._forward(*(
                    torch.from_numpy(np.ascontiguousarray(a))
                    for a in arrays)).numpy()
        offs = np.cumsum(self.num_classes)[:-1]
        return np.split(packed, offs, axis=-1)


__all__ = ["Predictor", "BucketedPredictor", "crop_border"]
