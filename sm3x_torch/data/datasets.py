"""Dataset registry, datasets by name: the port's own copy of
sm3x/data/datasets.py, which it does not import. The paired Derm7pt sets
feed the four stages; the single-image ISIC sets feed the transfer probe
(sm3x_torch.train.transfer_probe)."""

from __future__ import annotations

import os

import numpy as np

from sm3x_torch.data.derm7pt import Derm7ptMeta
from sm3x_torch.data.pipeline import (ImageStore, PairedImageData,
                                      iter_batch_selections)


def SevenPCBaseDataset(data_path: str, mode: str, cache_size: int = 320,
                       workers: int = 8, grouped: bool = True,
                       streaming: bool = False):
    """Paired (derm, clinic, label[8]) split over the grouped schema.
    `streaming=True` (--no-cache-images) decodes batches just in time
    instead of building the canvas cache (sm3x_torch.data.streaming)."""
    meta = Derm7ptMeta(data_path, grouped=grouped)
    if streaming:
        from sm3x_torch.data.streaming import StreamingPairedData

        return StreamingPairedData.from_meta(meta, mode, cache_size, workers)
    return PairedImageData.from_meta(meta, mode, cache_size, workers)


# SevenPCBaseDataset2 (one joint transform over the derm + clinic pair) and
# SevenPCSwavDataset (multi-crop) share SevenPCBaseDataset's canvases; what
# differs is the augmentation, which runs on the device and is picked by
# name in the trainers: joint parameters for the pair under the first,
# local views beside the two global ones in stage 1 under the second (the
# later stages augment it as SevenPCBaseDataset).
SevenPCBaseDataset2 = SevenPCBaseDataset
SevenPCSwavDataset = SevenPCBaseDataset


class SingleImageData:
    """Single-modality dataset (the ISIC transfer tasks): an image and its
    binary label columns from a CSV whose first column is the image id."""

    def __init__(self, image_dir: str, label_csv: str, cache_size: int = 320,
                 workers: int = 8, ext: str = ".jpg"):
        import pandas as pd

        df = pd.read_csv(label_csv)
        ids = df.iloc[:, 0].astype(str).tolist()
        self.labels = df.iloc[:, 1:].to_numpy().astype(np.int32)
        paths = [os.path.join(image_dir, i + ext) for i in ids]
        self.store = ImageStore(paths, cache_size, crop_amount=0,
                                workers=workers)
        self.n = len(paths)

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 3407,
                shuffle: bool = True):
        """(canvases, valid sizes, labels, indexes, mask) of fixed-size
        batches; the last one padded by wrapping and masked."""
        idx = np.arange(self.n)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(idx)
        for sel, mask in iter_batch_selections(idx, batch_size):
            yield (self.store.canvases[sel], self.store.valid_hw[sel],
                   self.labels[sel], sel.astype(np.int32), mask)


def _no_streaming(name: str, streaming: bool):
    if streaming:
        raise NotImplementedError(
            f"--no-cache-images (streaming decode) applies to the paired "
            f"Derm7pt datasets, not {name}")


def ISIC17Dataset(data_path: str, mode: str, cache_size: int = 320,
                  workers: int = 8, streaming: bool = False) -> SingleImageData:
    _no_streaming("ISIC17Dataset", streaming)
    sub = ("ISIC-2017_Training_Data" if mode == "train"
           else "ISIC-2017_Test_v2_Data")
    csv = "train_labels.csv" if mode == "train" else "test_labels.csv"
    return SingleImageData(os.path.join(data_path, sub),
                           os.path.join(data_path, csv), cache_size, workers)


def ISIC18Dataset(data_path: str, mode: str, cache_size: int = 320,
                  workers: int = 8, streaming: bool = False) -> SingleImageData:
    _no_streaming("ISIC18Dataset", streaming)
    sub = ("ISIC2018_Task1-2_Training_Input" if mode == "train"
           else "ISIC2018_Task1-2_Test_Input")
    csv = "train_labels.csv" if mode == "train" else "test_labels.csv"
    return SingleImageData(os.path.join(data_path, sub),
                           os.path.join(data_path, csv), cache_size, workers)


# the paired sets the four stages take, and the single-image ones
PAIRED = ("SevenPCBaseDataset", "SevenPCBaseDataset2", "SevenPCSwavDataset")
SINGLE_IMAGE = ("ISIC17Dataset", "ISIC18Dataset")

REGISTRY = {
    "SevenPCBaseDataset": SevenPCBaseDataset,
    "SevenPCBaseDataset2": SevenPCBaseDataset2,
    "SevenPCSwavDataset": SevenPCSwavDataset,
    "ISIC17Dataset": ISIC17Dataset,
    "ISIC18Dataset": ISIC18Dataset,
}


def build_dataset(data_name: str, data_path: str, mode: str, **kw):
    if data_name not in REGISTRY:
        raise KeyError(f"unknown dataset {data_name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[data_name](data_path, mode, **kw)
