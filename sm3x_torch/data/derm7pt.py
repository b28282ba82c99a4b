"""Derm7pt (7-point checklist) metadata layer: the port's own copy of
sm3x/data/derm7pt.py, which it does not import.

The pandas schema of the skin-sm3 release (its
src/utils/data/datasets.py:18-474): the 8 label
categories (1 diagnosis + 7 checklist criteria), string->numeric label
tables in both the original and the *grouped* variant
(SevenPCGroupDataset :439-474 — the one the pipeline actually uses,
:548), CSV-driven train/valid/test splits, image-path resolution and the
25-px black-border crop convention.

The tables below are dataset facts (category/label vocabulary of the
Derm7pt release + the SM3 grouping); the implementation is plain dicts +
numpy instead of pandas-DataFrame plumbing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Union

import numpy as np

LabelNames = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class LabelDef:
    num: int
    names: LabelNames          # one string or a group of synonymous strings
    abbrev: str
    score: int = 0             # 7-point checklist score contribution


@dataclasses.dataclass(frozen=True)
class CategoryDef:
    name: str
    abbrev: str
    colname: str               # column in meta.csv
    seven_pt: int              # 1 if part of the 7-point criteria
    labels: Sequence[LabelDef]

    @property
    def n_classes(self) -> int:
        return len(self.labels)


def _cat(name, abbrev, colname, seven_pt, rows):
    return CategoryDef(name, abbrev, colname, seven_pt,
                       tuple(LabelDef(*r) for r in rows))


# --- original (ungrouped) label tables, datasets.py:45-114 ----------------

DIAGNOSIS_FULL = _cat("Diagnosis", "DIAG", "diagnosis", 0, [
    (0, "basal cell carcinoma", "BCC"),
    (1, "blue nevus", "BLN"),
    (2, "clark nevus", "CN"),
    (3, "combined nevus", "CBN"),
    (4, "congenital nevus", "CGN"),
    (5, "dermal nevus", "DN"),
    (6, "dermatofibroma", "DF"),
    (7, "lentigo", "LT"),
    (8, ("melanoma", "melanoma (in situ)", "melanoma (less than 0.76 mm)",
         "melanoma (0.76 to 1.5 mm)", "melanoma (more than 1.5 mm)",
         "melanoma metastasis"), "MEL"),
    (9, "melanosis", "MLS"),
    (10, "miscellaneous", "MISC"),
    (11, "recurrent nevus", "RN"),
    (12, "reed or spitz nevus", "RSN"),
    (13, "seborrheic keratosis", "SK"),
    (14, "vascular lesion", "VL"),
])

PIGMENT_NETWORK = _cat("Pigment Network", "PN", "pigment_network", 1, [
    (0, "absent", "ABS", 0),
    (1, "typical", "TYP", 0),
    (2, "atypical", "ATP", 2),
])

BLUE_WHITISH_VEIL = _cat("Blue Whitish Veil", "BWV", "blue_whitish_veil", 1, [
    (0, "absent", "ABS", 0),
    (1, "present", "PRS", 2),
])

VASCULAR_STRUCTURES_FULL = _cat("Vascular Structures", "VS", "vascular_structures", 1, [
    (0, "absent", "ABS", 0),
    (1, "arborizing", "ARB", 0),
    (2, "comma", "COM", 0),
    (3, "hairpin", "HP", 0),
    (4, "within regression", "WR", 0),
    (5, "wreath", "WTH", 0),
    (6, "dotted", "DOT", 2),
    (7, "linear irregular", "LIR", 2),
])

PIGMENTATION_FULL = _cat("Pigmentation", "PIG", "pigmentation", 1, [
    (0, "absent", "ABS", 0),
    (1, "diffuse regular", "DR", 0),
    (2, "localized regular", "LR", 0),
    (3, "diffuse irregular", "DI", 1),
    (4, "localized irregular", "LI", 1),
])

STREAKS = _cat("Streaks", "STR", "streaks", 1, [
    (0, "absent", "ABS", 0),
    (1, "regular", "REG", 0),
    (2, "irregular", "IR", 1),
])

DOTS_AND_GLOBULES = _cat("Dots and Globules", "DaG", "dots_and_globules", 1, [
    (0, "absent", "ABS", 0),
    (1, "regular", "REG", 0),
    (2, "irregular", "IR", 1),
])

REGRESSION_STRUCTURES_FULL = _cat(
    "Regression Structures", "RS", "regression_structures", 1, [
        (0, "absent", "ABS", 0),
        (1, "blue areas", "BA", 1),
        (2, "white areas", "WA", 1),
        (3, "combinations", "CMB", 1),
    ])

# --- grouped tables (SevenPCGroupDataset, datasets.py:439-474) -------------
# The SM3 pipeline trains/evaluates on this grouping: DIAG -> 5 classes,
# VS/PIG -> 3, RS -> 2 (NUM_CLASSES = [5,3,2,3,3,3,3,2]).

DIAGNOSIS_GROUPED = _cat("Diagnosis", "DIAG", "diagnosis", 0, [
    (0, "basal cell carcinoma", "BCC"),
    (1, ("nevus", "blue nevus", "clark nevus", "combined nevus",
         "congenital nevus", "dermal nevus", "recurrent nevus",
         "reed or spitz nevus"), "NEV"),
    (2, ("melanoma", "melanoma (in situ)", "melanoma (less than 0.76 mm)",
         "melanoma (0.76 to 1.5 mm)", "melanoma (more than 1.5 mm)",
         "melanoma metastasis"), "MEL"),
    (3, ("DF/LT/MLS/MISC", "dermatofibroma", "lentigo", "melanosis",
         "miscellaneous", "vascular lesion"), "MISC"),
    (4, "seborrheic keratosis", "SK"),
])

VASCULAR_STRUCTURES_GROUPED = _cat(
    "Vascular Structures", "VS", "vascular_structures", 1, [
        (0, "absent", "ABS", 0),
        (1, ("regular", "arborizing", "comma", "hairpin",
             "within regression", "wreath"), "REG", 0),
        (2, ("dotted/irregular", "dotted", "linear irregular"), "IR", 2),
    ])

PIGMENTATION_GROUPED = _cat("Pigmentation", "PIG", "pigmentation", 1, [
    (0, "absent", "ABS", 0),
    (1, ("regular", "diffuse regular", "localized regular"), "REG", 0),
    (2, ("irregular", "diffuse irregular", "localized irregular"), "IR", 1),
])

REGRESSION_STRUCTURES_GROUPED = _cat(
    "Regression Structures", "RS", "regression_structures", 1, [
        (0, "absent", "ABS", 0),
        (1, ("present", "blue areas", "white areas", "combinations"), "PRS", 1),
    ])

# canonical label order fed to the model (datasets.py:478)
LABEL_ORD = ["DIAG", "PN", "BWV", "VS", "PIG", "STR", "DaG", "RS"]

FULL_SCHEMA: Dict[str, CategoryDef] = {
    "DIAG": DIAGNOSIS_FULL, "PN": PIGMENT_NETWORK, "BWV": BLUE_WHITISH_VEIL,
    "VS": VASCULAR_STRUCTURES_FULL, "PIG": PIGMENTATION_FULL, "STR": STREAKS,
    "DaG": DOTS_AND_GLOBULES, "RS": REGRESSION_STRUCTURES_FULL,
}

GROUPED_SCHEMA: Dict[str, CategoryDef] = {
    "DIAG": DIAGNOSIS_GROUPED, "PN": PIGMENT_NETWORK, "BWV": BLUE_WHITISH_VEIL,
    "VS": VASCULAR_STRUCTURES_GROUPED, "PIG": PIGMENTATION_GROUPED,
    "STR": STREAKS, "DaG": DOTS_AND_GLOBULES,
    "RS": REGRESSION_STRUCTURES_GROUPED,
}


def strings2numeric(strings: Sequence[str], category: CategoryDef,
                    sentinel: int = -1) -> np.ndarray:
    """Map label strings to class ids; raise on unknown strings
    (datasets.py:403-436 semantics)."""
    strings = np.asarray(strings, dtype=object)
    numeric = np.full(len(strings), sentinel, dtype=np.int64)
    for lab in category.labels:
        names = lab.names if isinstance(lab.names, (tuple, list)) else (lab.names,)
        for name in names:
            numeric[strings == name] = lab.num
    if np.any(numeric == sentinel):
        bad = strings[numeric == sentinel][0]
        raise ValueError(
            f"label string {bad!r} not in category {category.abbrev!r} vocabulary")
    return numeric


class Derm7ptMeta:
    """Parsed metadata: numeric labels, splits, image paths.

    Expects the release's on-disk layout (datasets.py:543-546):
      <root>/meta.csv, <root>/{train,valid,test}_indexes.csv (col 'indexes'),
      <root>/images/<relative image paths in 'derm'/'clinic' columns>.
    """

    def __init__(self, root: str, grouped: bool = True, crop_amount: int = 25):
        import pandas as pd

        self.root = root
        self.dir_images = os.path.join(root, "images")
        self.crop_amount = crop_amount
        self.schema = GROUPED_SCHEMA if grouped else FULL_SCHEMA

        df = pd.read_csv(os.path.join(root, "meta.csv"))
        self.df = df
        self.splits = {}
        for split, fname in (("train", "train_indexes.csv"),
                             ("valid", "valid_indexes.csv"),
                             ("test", "test_indexes.csv")):
            self.splits[split] = np.asarray(
                pd.read_csv(os.path.join(root, fname))["indexes"], dtype=np.int64)

        # split sanity (datasets.py:143-149)
        all_idx = np.concatenate(list(self.splits.values()))
        if len(set(all_idx.tolist())) != len(all_idx):
            raise ValueError("duplicate indexes across train/valid/test splits")
        if not np.array_equal(np.sort(all_idx), np.arange(len(df))):
            import warnings

            warnings.warn("train/valid/test indexes do not cover meta.csv rows")

        # numeric labels, LABEL_ORD order -> (N, 8) int64
        cols = []
        for abbrev in LABEL_ORD:
            cat = self.schema[abbrev]
            cols.append(strings2numeric(df[cat.colname].tolist(), cat))
        self.labels = np.stack(cols, axis=1)

        self.derm_paths = [os.path.join(self.dir_images, str(p)) for p in df["derm"]]
        self.clinic_paths = [os.path.join(self.dir_images, str(p)) for p in df["clinic"]]

        # patient metadata (datasets.py:156-158 get_dict_labels: sorted
        # unique strings -> codes). Third modality for the tri-modal
        # stretch model (ROADMAP.md, slice E).
        self.meta_fields = ["elevation", "sex", "location"]
        self.meta_vocabs = {}
        codes = []
        for field in self.meta_fields:
            if field in df.columns:
                names = sorted(set(str(v) for v in df[field]))
                vocab = {n: i for i, n in enumerate(names)}
                codes.append(np.asarray([vocab[str(v)] for v in df[field]],
                                        dtype=np.int32))
            else:
                vocab = {"unknown": 0}
                codes.append(np.zeros(len(df), dtype=np.int32))
            self.meta_vocabs[field] = vocab
        self.meta_codes = np.stack(codes, axis=1)  # (N, 3)

    def num_classes(self) -> List[int]:
        return [self.schema[a].n_classes for a in LABEL_ORD]

    def split_indexes(self, split: str) -> np.ndarray:
        key = {"train": "train", "val": "valid", "valid": "valid", "test": "test"}[split]
        return self.splits[key]

    def examples(self, split: str):
        """-> (derm_paths, clinic_paths, labels (n, 8)) for a split."""
        idx = self.split_indexes(split)
        return (
            [self.derm_paths[i] for i in idx],
            [self.clinic_paths[i] for i in idx],
            self.labels[idx],
        )
