"""Transfer linear probe: one pretrained modality encoder over a
single-image dataset, the ISIC sets (counterpart of
sm3x/train/transfer_probe.py).

Load a stage-1 checkpoint, take its derm or clinic encoder, freeze it, and
linear-probe the dataset's binary label columns: one 2-class head a column,
named `L{i}`, the positive class the column's value 1. The frozen encoder
runs forward only, in eval mode, on views made every epoch: kernel K1's
crop, flip and normalise (`PROBE_AUG`) in training, the deterministic
resize in eval, with ImageNet's mean and std (ISIC images are photographs,
not Derm7pt's). The heads are the port's `LinearProbe`.

The checkpoint is a `.pth` of the port's stage 1 (`ckp_*.pth`, any
--arch-version: the encoders are keyed `{derm,clinic}_backbone.encoder.*`)
or a reference-convention `.pth` of the same layout. The JAX package's
msgpack checkpoints are not read (ROADMAP.md, "Do not port").
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from sm3x_torch.core import prng
from sm3x_torch.core.mesh import local_rows
from sm3x_torch.data.prefetch import to_device
from sm3x_torch.models import backbones
from sm3x_torch.ops.augment import (PROBE_AUG, eval_resize_batch,
                                    ssl_augment_batch)
from sm3x_torch.train.linear_probe import LinearProbe
from sm3x_torch.utils.misc import setup_logger

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MODALITIES = {"derm": "derm_backbone", "clinic": "clinic_backbone"}


@dataclasses.dataclass
class SingleBatch:
    """What `LinearProbe.run` reads (`label`, `index`, `mask`) and the
    single-modality payload the extract function reads."""

    image: np.ndarray       # (B, S, S, 3) uint8 canvases
    image_hw: np.ndarray    # (B, 2) int32 valid sizes
    label: np.ndarray       # (B, L) int32 binary columns
    index: np.ndarray
    mask: np.ndarray


class SingleProbeData:
    """A `SingleImageData`'s tuple batches as `SingleBatch` objects."""

    def __init__(self, data):
        self.data = data
        self.n = data.n
        self.num_labels = data.labels.shape[1]

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 3407,
                shuffle: bool = True):
        for canv, hw, labels, idx, mask in self.data.batches(
                batch_size, epoch, seed, shuffle):
            yield SingleBatch(canv, hw, labels, idx, mask)


def make_single_extract_fn(encoder, device, mean, std, img_sz=(224, 224),
                           train_aug=PROBE_AUG, dtype=torch.bfloat16):
    """The frozen encoder's feature function on this rank's rows of a
    `SingleBatch`: train views from the seed's stream 0 (drawn for the whole
    batch), eval views from the resize; the encoder under `dtype` autocast
    (bf16, as the JAX package runs it; float32 runs it without autocast),
    and float32 features."""
    aug = dataclasses.replace(train_aug, out_size=tuple(img_sz))
    device = torch.device(device)

    @torch.no_grad()
    def extract(batch, seed: int, train: bool) -> torch.Tensor:
        rows = local_rows(len(batch.index))
        image, hw = (to_device(rows.take(x), device)
                     for x in (batch.image, batch.image_hw))
        if train:
            x = ssl_augment_batch(
                prng.generator(prng.fold_in(seed, 0), device), image, hw,
                mean, std, aug, rows)
        else:
            x = eval_resize_batch(image, hw, mean, std, tuple(img_sz))
        with torch.autocast(device.type, dtype=dtype,
                            enabled=dtype != torch.float32):
            return encoder(x).float()

    return extract


def load_single_encoder(pretrain_path: str, arch: str, modality: str,
                        device, img_sz=(224, 224)):
    """The `modality` encoder of a stage-1 `.pth`, strictly loaded, frozen,
    in eval mode on `device`."""
    from sm3x_torch.utils.checkpoint import load_state_dict_file

    if modality not in MODALITIES:
        raise ValueError(f"modality must be one of {sorted(MODALITIES)}, "
                         f"got {modality!r}")
    prefix = f"{MODALITIES[modality]}.encoder."
    state = {k[len(prefix):]: v
             for k, v in load_state_dict_file(pretrain_path).items()
             if k.startswith(prefix)}
    if not state:
        raise ValueError(f"{pretrain_path} holds no '{prefix}*' weights: not "
                         f"a stage-1 checkpoint")
    encoder = backbones.build_backbone(arch, img_size=tuple(img_sz))
    encoder.load_state_dict(state, strict=True)
    encoder.to(device).eval().requires_grad_(False)
    if torch.device(device).type == "cuda":
        encoder.to(memory_format=torch.channels_last)
    return encoder


def run_transfer_probe(pretrain_path: str, data_name: str, data_path: str,
                       arch: str = "resnet50", modality: str = "derm",
                       img_sz=(224, 224), batch_size: int = 64,
                       epochs: int = 50, ft_lr: float = 1e-3,
                       wd: float = 5e-2, seed: int = 3407,
                       mean: Sequence[float] = IMAGENET_MEAN,
                       std: Sequence[float] = IMAGENET_STD,
                       cache_size: int = 320, workers: int = 8,
                       logger=None, device="cuda") -> dict:
    """Probe `pretrain_path`'s `modality` encoder on an ISIC-style dataset;
    returns the best val stats dict (by AUC_AVG, as the paired probe)."""
    from sm3x_torch.data.datasets import build_dataset

    logger = logger or setup_logger(None, "sm3x_torch.transfer")
    encoder = load_single_encoder(pretrain_path, arch, modality, device,
                                  img_sz)
    train, test = (SingleProbeData(build_dataset(
        data_name, data_path, mode, cache_size=cache_size, workers=workers))
        for mode in ("train", "test"))
    if train.num_labels != test.num_labels:
        raise ValueError(f"train has {train.num_labels} label columns, "
                         f"test {test.num_labels}")
    ncols = train.num_labels
    extract = make_single_extract_fn(encoder, device, tuple(mean), tuple(std),
                                     tuple(img_sz))
    probe = LinearProbe(
        backbones.feat_dim(arch), ft_lr=ft_lr, wd=wd,
        num_classes=(2,) * ncols, seed=seed, device=device,
        classes_name=tuple(f"L{i}" for i in range(ncols)),
        cls_weights=(1,) * ncols)
    logger.info(f"transfer probe: {modality} {arch} encoder from "
                f"{pretrain_path} on {data_name} ({train.n} train / "
                f"{test.n} test, {ncols} binary labels)")
    best = probe.run(extract, train, test, batch_size, epochs=epochs,
                     label_weights=(1.0,) * ncols, seed=seed, logger=logger)
    logger.info(f"transfer probe best val AUC_AVG: {best['AUC_AVG']:.4f}")
    return best


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Linear-probe one SSL-pretrained modality encoder of the "
        "PyTorch port on an ISIC-style single-image dataset")
    p.add_argument("--pretrain-path", required=True,
                   help="stage-1 checkpoint: a .pth of the port's stage 1, "
                   "or a reference-convention .pth with the same keys "
                   "(the JAX package's .msgpack files are not read)")
    p.add_argument("--data-name", default="ISIC17Dataset",
                   choices=("ISIC17Dataset", "ISIC18Dataset"))
    p.add_argument("--data-path", required=True)
    p.add_argument("-a", "--arch", default="resnet50")
    p.add_argument("--modality", default="derm", choices=sorted(MODALITIES))
    p.add_argument("--img-sz", nargs=2, type=int, default=[224, 224])
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--ft-lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=5e-2)
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--mean", nargs=3, type=float, default=list(IMAGENET_MEAN))
    p.add_argument("--std", nargs=3, type=float, default=list(IMAGENET_STD))
    p.add_argument("--cache-size", type=int, default=320)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="the card (default), or cpu")
    args = p.parse_args(argv)
    best = run_transfer_probe(
        args.pretrain_path, args.data_name, args.data_path, args.arch,
        args.modality, tuple(args.img_sz), args.batch_size, args.epochs,
        args.ft_lr, args.wd, args.seed, tuple(args.mean), tuple(args.std),
        args.cache_size, args.workers, device=args.device)
    print({k: round(v, 4) for k, v in best.items()})
    return best


if __name__ == "__main__":
    main()
