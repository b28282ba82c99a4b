"""Tri-modal contrastive model (counterpart of sm3x/models/trimodal.py:
`MetaEncoder` :26, `TriModalSimCLR` :54, `trimodal_ssl_loss` :102).

A patient-metadata branch (one embedding a categorical field: elevation,
sex, location for Derm7pt; then an MLP) joins the derm and clinic image
branches. Its two "views" are two dropout draws over the concatenated
embeddings, so the NT-Xent machinery applies unchanged; derm <-> clinic,
derm <-> meta and clinic <-> meta are contrasted through V32-style
per-modality cross projectors, each view its own batch-norm batch.

Dropout draws from a `torch.Generator` handed to `forward`; inside
`sm3x_torch.core.mesh.batch_rows(rows)` every mask is drawn for the global
batch and cut to this rank's rows (sm3x_torch.models.transformer.dropout),
so a run's masks do not depend on the number of processes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from sm3x_torch.losses.ssl import ntxent_terms
from sm3x_torch.models import backbones
from sm3x_torch.models.projector import SSLProjector, _linear
from sm3x_torch.models.simclr import TwoBranches
from sm3x_torch.models.transformer import dropout


class MetaEncoder(nn.Module):
    """Categorical metadata codes (B, F) -> (B, feat_dim): an `nn.Embedding`
    a field (`embeds.{i}`), concatenated, dropout, `fc1`, ReLU, `fc2`.
    Initialised as Flax initialises them: embedding tables N(0, 1 /
    embed_dim) (`nn.Embed`'s variance scaling over its feature axis, not
    torch's N(0, 1)), linear weights U(+-1 / sqrt(fan_in)), biases 0."""

    def __init__(self, vocab_sizes: Sequence[int], embed_dim: int = 64,
                 feat_dim: int = 256, drop_rate: float = 0.2):
        super().__init__()
        self.drop_rate = drop_rate
        self.embeds = nn.ModuleList(nn.Embedding(v, embed_dim)
                                    for v in vocab_sizes)
        for emb in self.embeds:
            nn.init.normal_(emb.weight, std=1.0 / math.sqrt(embed_dim))
        fan_in = embed_dim * len(vocab_sizes)
        self.fc1 = _linear(fan_in, feat_dim, bias=True)
        self.fc2 = _linear(feat_dim, feat_dim, bias=True)
        for fc in (self.fc1, self.fc2):
            nn.init.zeros_(fc.bias)

    def forward(self, codes: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.cat([emb(codes[:, i]) for i, emb in enumerate(self.embeds)],
                      dim=-1)
        # embedding dropout is the metadata's augmentation for SSL views
        x = dropout(x, self.drop_rate, self.training, generator)
        return self.fc2(torch.relu(self.fc1(x)))


class TriModalSimCLR(TwoBranches):
    """derm / clinic image branches (any encoder of the registry, ViT
    included) and the metadata branch, with cross projectors
    `cross_proj_derm`, `cross_proj_clinic` and `cross_proj_meta`. The
    checkpoint keeps `derm_backbone.encoder.*` / `clinic_backbone.encoder.*`,
    which the later stages read."""

    def __init__(self, arch: str = "vit_b16", proj_dim: int = 128,
                 meta_vocab_sizes: Sequence[int] = (3, 3, 16),
                 meta_feat_dim: int = 256, amp: bool = False,
                 remat: Union[bool, str] = False,
                 img_size: Union[int, Sequence[int]] = 224):
        super().__init__(arch, proj_dim, amp, remat, img_size)
        self.meta_encoder = MetaEncoder(meta_vocab_sizes,
                                        feat_dim=meta_feat_dim)
        feat = backbones.feat_dim(arch)
        self.cross_proj_derm = SSLProjector(feat, proj_dim)
        self.cross_proj_clinic = SSLProjector(feat, proj_dim)
        self.cross_proj_meta = SSLProjector(meta_feat_dim, proj_dim)

    def forward(self, derm_imgs, clinic_imgs, meta_codes: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        """Two views a modality; the metadata's two views are two dropout
        draws from `generator`, in order."""
        derm_f, derm_z = self.derm_backbone(*derm_imgs)
        clinic_f, clinic_z = self.clinic_backbone(*clinic_imgs)
        metas = [self.meta_encoder(meta_codes, generator) for _ in range(2)]
        return {
            "derm_z": derm_z,
            "clinic_z": clinic_z,
            "cross_derm_z": tuple(self.cross_proj_derm(f) for f in derm_f),
            "cross_clinic_z": tuple(self.cross_proj_clinic(f)
                                    for f in clinic_f),
            "cross_meta_z": tuple(self.cross_proj_meta(m) for m in metas),
        }


def trimodal_ssl_loss(outputs: dict, temperature: float, groups: int = 1,
                      weights=(1.0, 1.0, 1.0), world: int = 1):
    """Intra-modal derm and clinic, the metadata's two dropout views, and
    every cross-modal pair at 0.5 a view: nine NT-Xent terms in one
    `ntxent_terms` call. Returns (total, {"derm", "clinic", "meta",
    "cross"}), this rank's share where it holds whole groups."""
    b = outputs["derm_z"].shape[0] // 2
    cd, cc = outputs["cross_derm_z"], outputs["cross_clinic_z"]
    cm = outputs["cross_meta_z"]
    pairs = [(outputs["derm_z"][:b], outputs["derm_z"][b:]),
             (outputs["clinic_z"][:b], outputs["clinic_z"][b:]),
             (cm[0], cm[1])]
    # derm <-> clinic, derm <-> meta, clinic <-> meta, view by view
    pairs += [(a[v], c[v]) for a, c in ((cd, cc), (cd, cm), (cc, cm))
              for v in range(2)]
    per_term = ntxent_terms(pairs, temperature, groups, world)
    derm, clinic, meta = per_term[0], per_term[1], per_term[2]
    cross = sum(0.5 * (per_term[3 + 2 * k] + per_term[4 + 2 * k])
                for k in range(3))
    total = weights[0] * derm + weights[1] * clinic + weights[2] * meta + cross
    return total, {"derm": derm, "clinic": clinic, "meta": meta,
                   "cross": cross}
