"""Feeding batches to the device (counterpart of sm3x/data/prefetch.py; the
port's own code, it imports nothing of the JAX package).

Three ways for a host dataset's canvases to reach the device:

  host      the trainer uploads each batch when it needs it, from pageable
            memory, on the step's own stream;
  resident  `DeviceData` (sm3x_torch.data.device_data): the whole canvas
            cache is uploaded once and a batch is an index gather on the
            device;
  prefetch  `PrefetchData`: a background thread slices the next batches and
            copies them up to `depth` ahead, so the copy of batch k+1 runs
            beside the device's step on batch k.

`wrap_for_device` picks one (`--device-feed`); under `auto` the resident
feed is taken when the canvases fit `--hbm-data-budget-mb`, else prefetch.
Under a process group each feed yields this rank's rows of every global
batch (sm3x_torch.data.multihost), and `auto` is the process-sharded
prefetch.
Under every feed a step sees the same samples: the order and the
wrap-padding come from `iter_batch_selections`, and the copies are exact.

On a CUDA device `PrefetchData` stages each batch in pinned host buffers (a
ring of `depth + 1`, allocated once) and copies with `non_blocking=True` on
a side stream. Before a batch is handed to the consumer, the consumer's
current stream is made to wait on the event of that batch's copy, and the
device tensors are `record_stream`ed on it, so the caching allocator does
not hand their memory out while the step still reads them. A pinned buffer
is not rewritten before the event of its last copy has passed. On the CPU
the same thread hands over plain CPU tensors.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import warnings
from typing import Iterator

import numpy as np
import torch

from sm3x_torch.data.pipeline import Batch
from sm3x_torch.parallel.collectives import is_distributed
from sm3x_torch.utils.profiling import annotate, count

DEVICE_FIELDS = ("derm", "derm_hw", "clinic", "clinic_hw")


def to_device(x, device) -> torch.Tensor:
    """A batch field on `device`: a tensor that a feed already put there is
    taken as it is, a numpy array is uploaded now. An upload from the host
    to a card waits for the stream (counted in `host.device_waits`)."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    out = x.to(device)
    if out.is_cuda and not x.is_cuda:
        count("host.device_waits")
    return out


def indexed(device) -> torch.device:
    """`device` with its index filled in ("cuda" -> the current card): a
    thread that the trainer did not start must be told which card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def iter_with_producer(make_items, depth: int, name: str):
    """Yield items from the iterator `make_items()` produced by a daemon
    thread running up to `depth` items ahead. The producer is cancelled
    when the consumer stops early (generator close or an exception
    unwinding): it stops after the item in flight instead of finishing the
    epoch. Producer exceptions re-raise in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def producer():
        try:
            it = make_items()
            while not stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    break
                q.put(item)  # blocks when full; the drain loop unblocks
        except BaseException as e:  # surface in the consumer
            q.put(e)
            return
        q.put(_END)

    t = threading.Thread(target=producer, daemon=True, name=name)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # unblock a producer stuck in q.put so it can see the stop flag
        while t.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        t.join(timeout=5)


class _PinnedRing:
    """`size` sets of pinned host buffers, used in turn. `upload` copies a
    batch's arrays into the next set and from there to the device on
    `stream`, without waiting for the device; it waits only where the set
    it is about to overwrite still has a copy in flight."""

    def __init__(self, size: int, device: torch.device):
        self.device = device
        self.slots = [None] * size
        self.next = 0

    def upload(self, arrays, stream):
        i, self.next = self.next, (self.next + 1) % len(self.slots)
        slot = self.slots[i]
        want = [(a.shape, a.dtype) for a in arrays]
        if slot is None or slot["layout"] != want:
            slot = self.slots[i] = {
                "layout": want,
                "bufs": [torch.empty_like(torch.from_numpy(a),
                                          pin_memory=True) for a in arrays],
                "copied": None}
        elif slot["copied"] is not None:
            count("host.device_waits")
            slot["copied"].synchronize()
        with torch.cuda.stream(stream):
            out = []
            for buf, a in zip(slot["bufs"], arrays):
                np.copyto(buf.numpy(), a)
                out.append(buf.to(self.device, non_blocking=True))
            copied = torch.cuda.Event()
            copied.record(stream)
        slot["copied"] = copied
        return out, copied


class PrefetchData:
    """Device-prefetching view over a host dataset (anything with
    `batches`, `steps_per_epoch`, `epoch_order`, `n`, `labels`).

    `batches` yields Batch objects whose derm / clinic canvases and sizes
    are already tensors on `device`, copied up to `depth` batches ahead of
    consumption. Labels, index, mask and meta stay on the host: they feed
    host logic or are tiny."""

    def __init__(self, data, device, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._host = data
        self.device = indexed(device)
        self.depth = depth
        self.n = data.n
        self.labels = data.labels
        self.meta_codes = getattr(data, "meta_codes", None)
        self.meta_vocab_sizes = getattr(data, "meta_vocab_sizes", None)
        self._ring = None
        self._stream = None

    def steps_per_epoch(self, batch_size: int) -> int:
        return self._host.steps_per_epoch(batch_size)

    def epoch_order(self, epoch: int, seed: int = 3407, shuffle: bool = True):
        return self._host.epoch_order(epoch, seed, shuffle)

    def _put_cuda(self, batch: Batch):
        """Producer thread: the batch's four arrays through the pinned ring,
        with the event of their copy."""
        arrays = [np.ascontiguousarray(getattr(batch, f))
                  for f in DEVICE_FIELDS]
        with annotate("feed.upload"):
            tensors, copied = self._ring.upload(arrays, self._stream)
        return dataclasses.replace(
            batch, **dict(zip(DEVICE_FIELDS, tensors))), copied

    def _put_cpu(self, batch: Batch):
        with annotate("feed.upload"):
            return dataclasses.replace(batch, **{
                f: to_device(getattr(batch, f), self.device)
                for f in DEVICE_FIELDS}), None

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 3407,
                shuffle: bool = True, pad: str = "wrap") -> Iterator[Batch]:
        on_card = self.device.type == "cuda"
        if on_card and self._ring is None:
            self._ring = _PinnedRing(self.depth + 1, self.device)
            self._stream = torch.cuda.Stream(self.device)
        put = self._put_cuda if on_card else self._put_cpu

        def items():
            if on_card:
                torch.cuda.set_device(self.device)  # the producer's thread
            for b in self._host.batches(batch_size, epoch, seed, shuffle):
                with annotate("feed.batch"):
                    item = put(b)
                yield item

        produced = iter_with_producer(items, self.depth,
                                      "sm3x-torch-prefetch")
        try:
            for batch, copied in produced:
                if copied is not None:
                    here = torch.cuda.current_stream(self.device)
                    here.wait_event(copied)
                    for f in DEVICE_FIELDS:
                        getattr(batch, f).record_stream(here)
                yield batch
        finally:
            # an early stop cancels the producer now, not when the garbage
            # collector finds the inner generator
            produced.close()


def resident_nbytes(wrapped) -> int:
    """Device bytes that a `wrap_for_device` result pinned for canvases (0
    unless it chose `DeviceData`). Pass it as `reserved_bytes` when wrapping
    further datasets, so that one budget covers them all."""
    from sm3x_torch.data.device_data import DeviceData

    if isinstance(wrapped, DeviceData):
        host = wrapped._host
        return int(host.derm.canvases.nbytes + host.clinic.canvases.nbytes)
    return 0


def wrap_for_device(data, device, hbm_budget_bytes: int | None = None,
                    depth: int = 2, strategy: str = "auto",
                    reserved_bytes: int = 0):
    """Pick the feed for a host PairedImageData: resident (`DeviceData`)
    when the canvas cache fits the budget, else prefetch (`PrefetchData`).
    `strategy` forces one: "resident", "prefetch", or "host" (the trainer
    uploads each batch itself). A streaming dataset
    (sm3x_torch.data.streaming) goes with the prefetch leg.
    `reserved_bytes` charges device memory that earlier wraps pinned
    against the budget. Other inputs (already wrapped, or synthetic) pass
    through unchanged.

    The default budget, 4096 MB, is about a twentieth of an H100's 80 GB:
    Derm7pt's train split at canvas 320 pins 0.25 GB of it, and a split of
    some 6,900 pairs is the largest that still fits."""
    from sm3x_torch.data.device_data import DeviceData
    from sm3x_torch.data.pipeline import PairedImageData
    from sm3x_torch.data.streaming import StreamingPairedData

    if strategy not in ("auto", "resident", "prefetch", "host"):
        raise ValueError(f"unknown device-feed strategy {strategy!r} "
                         "(auto|resident|prefetch|host)")
    if is_distributed():
        return _wrap_for_rank(data, device, depth, strategy)
    if isinstance(data, StreamingPairedData):
        # decoded just in time: nothing to make resident; overlap the
        # upload with compute unless the caller wants the host path
        if strategy == "host":
            return data
        if strategy == "resident":
            raise ValueError(
                "--device-feed resident needs the decoded canvas cache; "
                "streaming (--no-cache-images) decodes just-in-time — "
                "drop one of the two flags")
        return PrefetchData(data, device, depth=depth)
    if not isinstance(data, PairedImageData):
        if strategy in ("resident", "prefetch") and not isinstance(
                data, (DeviceData, PrefetchData)):
            warnings.warn(
                f"--device-feed {strategy} has no effect on "
                f"{type(data).__name__} (not a paired canvas dataset); "
                "feeding it as-is")
        return data
    if strategy == "host":
        return data
    if strategy == "resident":
        return DeviceData(data, device)
    if strategy == "prefetch":
        return PrefetchData(data, device, depth=depth)
    if hbm_budget_bytes is None:
        hbm_budget_bytes = 4 << 30
    cache_bytes = data.derm.canvases.nbytes + data.clinic.canvases.nbytes
    if cache_bytes + reserved_bytes <= hbm_budget_bytes:
        try:
            return DeviceData(data, device)
        except Exception:
            pass
    return PrefetchData(data, device, depth=depth)


def _wrap_for_rank(data, device, depth: int, strategy: str):
    """Under a process group every feed yields this rank's rows of each
    global batch (sm3x_torch.data.multihost): `auto` and `prefetch` take
    the process-sharded feed, `resident` uploads the canvas cache and
    gathers this rank's rows on the device, `host` cuts the host batches.
    A feed that is already wrapped passes through."""
    from sm3x_torch.data.device_data import DeviceData
    from sm3x_torch.data.multihost import LocalRows, ProcessShardedData
    from sm3x_torch.data.pipeline import PairedImageData

    if isinstance(data, (DeviceData, PrefetchData, LocalRows)):
        return data
    if strategy == "host":
        return LocalRows(data)
    if strategy == "resident":
        if not isinstance(data, PairedImageData):
            raise ValueError(
                "--device-feed resident needs the decoded canvas cache of a "
                f"paired dataset, not {type(data).__name__}")
        return DeviceData(data, device, local=True)
    return ProcessShardedData(data, device, depth=depth)


def wrap_from_config(data, device, data_cfg, reserved_bytes: int = 0):
    """`wrap_for_device` keyed by a DataConfig (--device-feed,
    --hbm-data-budget-mb, --prefetch-depth)."""
    return wrap_for_device(
        data, device,
        hbm_budget_bytes=int(getattr(data_cfg, "hbm_data_budget_mb", 4096)) << 20,
        depth=int(getattr(data_cfg, "prefetch_depth", 2)),
        strategy=getattr(data_cfg, "device_feed", "auto"),
        reserved_bytes=reserved_bytes)
