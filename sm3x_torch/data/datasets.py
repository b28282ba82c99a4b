"""Dataset registry, datasets by name: the port's own copy of what its
stage 1 takes from sm3x/data/datasets.py, which it does not import. The
single-image ISIC sets and streaming decode follow with their slices
(ROADMAP.md, items 11 and 14)."""

from __future__ import annotations

from sm3x_torch.data.derm7pt import Derm7ptMeta
from sm3x_torch.data.pipeline import PairedImageData


def SevenPCBaseDataset(data_path: str, mode: str, cache_size: int = 320,
                       workers: int = 8, grouped: bool = True):
    """Paired (derm, clinic, label[8]) split over the grouped schema."""
    meta = Derm7ptMeta(data_path, grouped=grouped)
    return PairedImageData.from_meta(meta, mode, cache_size, workers)


# SevenPCBaseDataset2 (one joint transform over the derm + clinic pair)
# shares SevenPCBaseDataset's canvases; what differs is the augmentation,
# which runs on the device and is picked by name in the trainer.
SevenPCBaseDataset2 = SevenPCBaseDataset

REGISTRY = {
    "SevenPCBaseDataset": SevenPCBaseDataset,
    "SevenPCBaseDataset2": SevenPCBaseDataset2,
}


def build_dataset(data_name: str, data_path: str, mode: str, **kw):
    if data_name not in REGISTRY:
        raise KeyError(f"unknown dataset {data_name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[data_name](data_path, mode, **kw)
