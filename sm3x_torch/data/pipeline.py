"""Host side of the input pipeline: the port's own copy of
sm3x/data/pipeline.py, which it does not import.

Each image is decoded once (OpenCV, BGR -> RGB), border-cropped (25 px)
and letterboxed into a fixed uint8 canvas that stays in RAM (Derm7pt is
about 2k images, a few hundred MB). Every epoch then only slices canvases
into batches; all random augmentation runs on the device
(sm3x_torch.ops.augment). The canvas keeps the image's aspect ratio and
records the valid (h, w), so RandomResizedCrop samples the geometry of
full-resolution crops.

JPEGs are decoded by the multi-threaded libjpeg loader
(sm3x_torch/native/loader.cpp); every file it does not take (a PNG, or all
of them where the loader cannot be built) goes through OpenCV.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
from typing import Sequence, Tuple

import numpy as np


def decode_image(path: str) -> np.ndarray:
    """OpenCV decode to RGB uint8."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def letterbox(img: np.ndarray, size: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Fit `img` into a (size, size) canvas top-left, preserving aspect.
    Returns (canvas uint8, valid (h, w)). Only an image larger than the
    canvas is resized, and only that needs OpenCV."""
    h, w = img.shape[:2]
    scale = min(size / h, size / w)
    if scale < 1.0:
        import cv2

        nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
    else:
        nh, nw = h, w
    canvas = np.zeros((size, size, 3), dtype=np.uint8)
    canvas[:nh, :nw] = img
    return canvas, (nh, nw)


def decode_canvas_batch(paths: Sequence[str], cache_size: int,
                        crop_amount: int = 25, workers: int = 8,
                        use_native: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode `paths` into ((N, S, S, 3) uint8 canvases, (N, 2) int32 valid
    hw) on `workers` threads. JPEGs go through the native libjpeg loader;
    whatever it does not take (a PNG, a missing toolchain) goes through the
    OpenCV path, file by file."""
    n = len(paths)
    canvases = np.zeros((n, cache_size, cache_size, 3), dtype=np.uint8)
    valid_hw = np.zeros((n, 2), dtype=np.int32)

    todo = list(range(n))
    if use_native and n:
        try:
            from sm3x_torch.native.loader import decode_letterbox_batch

            canv, hw, ok = decode_letterbox_batch(
                list(paths), cache_size, crop_amount, workers)
            done = np.nonzero(ok)[0]
            canvases[done] = canv[done]
            valid_hw[done] = hw[done]
            todo = [i for i in range(n) if not ok[i]]
        except Exception:
            todo = list(range(n))

    def load(i):
        img = decode_image(paths[i])[:, :, :3]
        # only crop when a non-empty interior remains (the native loader's
        # rule too)
        if (crop_amount > 0 and img.shape[0] > 2 * crop_amount
                and img.shape[1] > 2 * crop_amount):
            img = img[crop_amount:-crop_amount, crop_amount:-crop_amount]
        canvases[i], valid_hw[i] = letterbox(img, cache_size)

    if todo:
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(load, todo))
    return canvases, valid_hw


class ImageStore:
    """Decode-once uint8 canvas cache for a list of image paths."""

    def __init__(self, paths: Sequence[str], cache_size: int = 320,
                 crop_amount: int = 25, workers: int = 8,
                 use_native: bool = True):
        self.cache_size = cache_size
        self.crop_amount = crop_amount
        self.canvases, self.valid_hw = decode_canvas_batch(
            paths, cache_size, crop_amount, workers, use_native)

    @classmethod
    def from_arrays(cls, canvases: np.ndarray, valid_hw: np.ndarray):
        """A store over canvases that are already in memory."""
        store = cls([], canvases.shape[1], crop_amount=0)
        store.canvases = np.ascontiguousarray(canvases, dtype=np.uint8)
        store.valid_hw = np.ascontiguousarray(valid_hw, dtype=np.int32)
        return store


@dataclasses.dataclass
class Batch:
    derm: np.ndarray          # (B, S, S, 3) uint8 canvases
    derm_hw: np.ndarray       # (B, 2) int32
    clinic: np.ndarray
    clinic_hw: np.ndarray
    label: np.ndarray         # (B, 8) int32
    index: np.ndarray         # (B,) int32 dataset indices
    mask: np.ndarray          # (B,) bool, False on wrap-padding (eval)
    meta: np.ndarray = None   # (B, F) int32 metadata codes (tri-modal)


def iter_batch_selections(order: np.ndarray, batch_size: int):
    """Yield (sel, mask) index slices of `order`, padded by wrapping to a
    fixed batch size: the one definition of which samples each step sees.
    Mask is False on wrap-padding."""
    n = len(order)
    for start in range(0, n, batch_size):
        sel = order[start:start + batch_size]
        mask = np.ones(len(sel), dtype=bool)
        if len(sel) < batch_size:
            padn = batch_size - len(sel)
            # np.resize tiles when padn > n (tiny splits vs big batches)
            sel = np.concatenate([sel, np.resize(order, padn)])
            mask = np.concatenate([mask, np.zeros(padn, dtype=bool)])
        yield sel, mask


class PairedImageData:
    """A split of paired derm/clinic canvases + labels, ready to batch."""

    def __init__(self, derm_paths, clinic_paths, labels,
                 cache_size: int = 320, crop_amount: int = 25, workers: int = 8,
                 meta_codes=None, meta_vocab_sizes=None):
        self.derm = ImageStore(derm_paths, cache_size, crop_amount, workers)
        self.clinic = ImageStore(clinic_paths, cache_size, crop_amount, workers)
        self.labels = np.asarray(labels, dtype=np.int32)
        self.n = len(derm_paths)
        # categorical patient metadata codes, the tri-modal model's third
        # modality
        self.meta_codes = (None if meta_codes is None
                           else np.asarray(meta_codes, dtype=np.int32))
        self.meta_vocab_sizes = meta_vocab_sizes

    @classmethod
    def from_canvases(cls, derm, derm_hw, clinic, clinic_hw, labels):
        """A split over canvases that are already in memory (synthetic
        data): nothing is decoded."""
        data = cls([], [], labels, cache_size=derm.shape[1], crop_amount=0)
        data.derm = ImageStore.from_arrays(derm, derm_hw)
        data.clinic = ImageStore.from_arrays(clinic, clinic_hw)
        data.n = len(derm)
        return data

    @classmethod
    def from_meta(cls, meta, split: str, cache_size: int = 320, workers: int = 8):
        d, c, y = meta.examples(split)
        idx = meta.split_indexes(split)
        return cls(d, c, y, cache_size, meta.crop_amount, workers,
                   meta_codes=meta.meta_codes[idx],
                   meta_vocab_sizes=[len(meta.meta_vocabs[f])
                                     for f in meta.meta_fields])

    def epoch_order(self, epoch: int, seed: int = 3407, shuffle: bool = True):
        """Deterministic per-epoch permutation."""
        idx = np.arange(self.n)
        if shuffle:
            rng = np.random.default_rng(seed + epoch)
            rng.shuffle(idx)
        return idx

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 3407,
                shuffle: bool = True):
        """Yield fixed-size Batches; see iter_batch_selections for the
        padding."""
        order = self.epoch_order(epoch, seed, shuffle)
        for sel, mask in iter_batch_selections(order, batch_size):
            yield Batch(
                derm=self.derm.canvases[sel],
                derm_hw=self.derm.valid_hw[sel],
                clinic=self.clinic.canvases[sel],
                clinic_hw=self.clinic.valid_hw[sel],
                label=self.labels[sel],
                index=sel.astype(np.int32),
                mask=mask,
                meta=(None if self.meta_codes is None
                      else self.meta_codes[sel]),
            )

    def steps_per_epoch(self, batch_size: int) -> int:
        return (self.n + batch_size - 1) // batch_size
