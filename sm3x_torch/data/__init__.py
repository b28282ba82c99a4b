"""The data layer of the port (counterpart of sm3x/data/): Derm7pt's
metadata, the decode-once canvas store and the dataset registry."""

from sm3x_torch.data.derm7pt import (  # noqa: F401
    FULL_SCHEMA, GROUPED_SCHEMA, LABEL_ORD, Derm7ptMeta)
from sm3x_torch.data.pipeline import (  # noqa: F401
    Batch, ImageStore, PairedImageData)
from sm3x_torch.data.datasets import REGISTRY, build_dataset  # noqa: F401

__all__ = ["Derm7ptMeta", "LABEL_ORD", "GROUPED_SCHEMA", "FULL_SCHEMA",
           "PairedImageData", "ImageStore", "Batch", "build_dataset",
           "REGISTRY"]
