"""Dataset registry, datasets by name: the port's own copy of what its
stages take from sm3x/data/datasets.py, which it does not import. The
single-image ISIC sets follow with their slice (ROADMAP.md, item 17)."""

from __future__ import annotations

from sm3x_torch.data.derm7pt import Derm7ptMeta
from sm3x_torch.data.pipeline import PairedImageData


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


# SevenPCBaseDataset2 (one joint transform over the derm + clinic pair)
# shares SevenPCBaseDataset's canvases; what differs is the augmentation,
# which runs on the device and is picked by name in the trainer.
SevenPCBaseDataset2 = SevenPCBaseDataset

REGISTRY = {
    "SevenPCBaseDataset": SevenPCBaseDataset,
    "SevenPCBaseDataset2": SevenPCBaseDataset2,
}


# the reference's single-image sets: not in the port's registry yet, and
# never streamed
SINGLE_IMAGE = ("ISIC17Dataset", "ISIC18Dataset")


def build_dataset(data_name: str, data_path: str, mode: str, **kw):
    if kw.get("streaming") and data_name in SINGLE_IMAGE:
        raise NotImplementedError(
            f"--no-cache-images (streaming decode) applies to the paired "
            f"Derm7pt datasets, not {data_name}")
    if data_name not in REGISTRY:
        raise KeyError(f"unknown dataset {data_name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[data_name](data_path, mode, **kw)
