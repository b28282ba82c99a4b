"""Pretrained-weight registry: torchvision enum name -> expected file,
integrity hash and meta. The port's own copy of
sm3x/utils/weight_registry.py, which it does not import.

The reference vendors torchvision's ``ResNet*_Weights`` enum tables with
their download URLs; its recipe boots SSL from ``IMAGENET1K_V1`` on
resnet50 (run.sh:11). Nothing is downloaded here: each enum name maps to
the local file it expects.

* ``--arch-weights IMAGENET1K_V1`` resolves the staged file by its
  canonical torchvision basename (searched in ``$SM3X_WEIGHTS_DIR``,
  ``~/.cache/sm3x_weights``, ``~/.cache/torch/hub/checkpoints`` and the
  CWD) and verifies its integrity;
* ``--arch-weights /path/to/file.pth`` works too, with the same integrity
  check whenever the basename matches a registry entry.

Integrity uses torchvision's own convention: the 8 hex chars embedded in
the canonical filename are the sha256 prefix of the file
(``torch.hub.load_state_dict_from_url`` checks exactly this), so a
truncated download or a mislabeled file fails loudly before any weight is
loaded.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    url: str
    num_params: int
    acc1: float  # ImageNet-1K acc@1, from the reference's meta tables

    @property
    def filename(self) -> str:
        return self.url.rsplit("/", 1)[1]

    @property
    def sha256_prefix(self) -> str:
        # torchvision canonical name: <arch>-<sha256[:8]>.pth
        return self.filename.rsplit("-", 1)[1].split(".")[0]


_TV = "https://download.pytorch.org/models/"

# (arch, enum) -> spec; URLs and meta are those of the reference's vendored
# enum tables (public torchvision facts)
WEIGHTS: Dict[Tuple[str, str], WeightSpec] = {
    ("resnet18", "IMAGENET1K_V1"): WeightSpec(_TV + "resnet18-f37072fd.pth", 11689512, 69.758),
    ("resnet34", "IMAGENET1K_V1"): WeightSpec(_TV + "resnet34-b627a593.pth", 21797672, 73.314),
    ("resnet50", "IMAGENET1K_V1"): WeightSpec(_TV + "resnet50-0676ba61.pth", 25557032, 76.130),
    ("resnet50", "IMAGENET1K_V2"): WeightSpec(_TV + "resnet50-11ad3fa6.pth", 25557032, 80.858),
    ("resnet101", "IMAGENET1K_V1"): WeightSpec(_TV + "resnet101-63fe2227.pth", 44549160, 77.374),
    ("resnet101", "IMAGENET1K_V2"): WeightSpec(_TV + "resnet101-cd907fc2.pth", 44549160, 81.886),
    ("resnet152", "IMAGENET1K_V1"): WeightSpec(_TV + "resnet152-394f9c45.pth", 60192808, 78.312),
    ("resnet152", "IMAGENET1K_V2"): WeightSpec(_TV + "resnet152-f82ba261.pth", 60192808, 82.284),
    ("resnext50_32x4d", "IMAGENET1K_V1"): WeightSpec(_TV + "resnext50_32x4d-7cdf4587.pth", 25028904, 77.618),
    ("resnext50_32x4d", "IMAGENET1K_V2"): WeightSpec(_TV + "resnext50_32x4d-1a0047aa.pth", 25028904, 81.198),
    ("resnext101_32x8d", "IMAGENET1K_V1"): WeightSpec(_TV + "resnext101_32x8d-8ba56ff5.pth", 88791336, 79.312),
    ("resnext101_32x8d", "IMAGENET1K_V2"): WeightSpec(_TV + "resnext101_32x8d-110c445d.pth", 88791336, 82.834),
    ("resnext101_64x4d", "IMAGENET1K_V1"): WeightSpec(_TV + "resnext101_64x4d-173b62eb.pth", 83455272, 83.246),
    ("wide_resnet50_2", "IMAGENET1K_V1"): WeightSpec(_TV + "wide_resnet50_2-95faca4d.pth", 68883240, 78.468),
    ("wide_resnet50_2", "IMAGENET1K_V2"): WeightSpec(_TV + "wide_resnet50_2-9ba9bcbe.pth", 68883240, 81.602),
    ("wide_resnet101_2", "IMAGENET1K_V1"): WeightSpec(_TV + "wide_resnet101_2-32ee1156.pth", 126886696, 78.848),
    ("wide_resnet101_2", "IMAGENET1K_V2"): WeightSpec(_TV + "wide_resnet101_2-d733dc28.pth", 126886696, 82.510),
}

# the reference enums' DEFAULT members (V1 for r18/r34/rx101_64,
# V2 where torchvision published the improved-recipe weights)
DEFAULTS: Dict[str, str] = {
    "resnet18": "IMAGENET1K_V1", "resnet34": "IMAGENET1K_V1",
    "resnet50": "IMAGENET1K_V2", "resnet101": "IMAGENET1K_V2",
    "resnet152": "IMAGENET1K_V2",
    "resnext50_32x4d": "IMAGENET1K_V2",
    "resnext101_32x8d": "IMAGENET1K_V2",
    "resnext101_64x4d": "IMAGENET1K_V1",
    "wide_resnet50_2": "IMAGENET1K_V2",
    "wide_resnet101_2": "IMAGENET1K_V2",
}

_BY_FILENAME: Dict[str, WeightSpec] = {
    s.filename: s for s in WEIGHTS.values()}


def _search_dirs():
    dirs = []
    env = os.environ.get("SM3X_WEIGHTS_DIR")
    if env:
        dirs.append(env)
    dirs += [
        os.path.expanduser("~/.cache/sm3x_weights"),
        os.path.expanduser("~/.cache/torch/hub/checkpoints"),
        os.getcwd(),
    ]
    return dirs


def sha256_prefix(path: str, n: int = 8, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()[:n]


def verify_weight_file(path: str, spec: WeightSpec) -> None:
    """torchvision-convention integrity check: file sha256 must start
    with the 8 hex chars embedded in the canonical filename. Opt out with
    SM3X_SKIP_WEIGHT_VERIFY=1 (e.g. re-serialized archives that changed
    bytes but not tensors)."""
    if os.environ.get("SM3X_SKIP_WEIGHT_VERIFY") == "1":
        return
    got = sha256_prefix(path, len(spec.sha256_prefix))
    if got != spec.sha256_prefix:
        raise ValueError(
            f"integrity check failed for '{path}': sha256 starts with "
            f"{got}, expected {spec.sha256_prefix} "
            f"(the canonical {spec.filename} from {spec.url}). The file is "
            f"truncated, corrupted, or not the named torchvision weights; "
            f"re-download it, or set SM3X_SKIP_WEIGHT_VERIFY=1 if the "
            f"content is intentionally re-serialized.")


def resolve_arch_weights(value: str, arch: str) -> str:
    """Resolve --arch-weights to a verified local .pth path.

    Accepts a filesystem path (verified when its basename is a known
    canonical torchvision file) or a weight-enum name from the
    reference's vendored tables ('IMAGENET1K_V1'/'IMAGENET1K_V2'/
    'DEFAULT'), resolved against the staged-weights search dirs."""
    if os.path.isfile(value):
        spec = _BY_FILENAME.get(os.path.basename(value))
        if spec is not None:
            verify_weight_file(value, spec)
        return value

    name = "DEFAULT" if value == "DEFAULT" else value
    if name == "DEFAULT":
        name = DEFAULTS.get(arch, "IMAGENET1K_V1")
    spec = WEIGHTS.get((arch, name))
    if spec is None:
        known = sorted(n for a, n in WEIGHTS if a == arch)
        raise FileNotFoundError(
            f"--arch-weights '{value}' is neither a file nor a weight enum "
            f"for {arch} (known enums: {known + ['DEFAULT']}). Pass the "
            f"path to a torchvision {arch} checkpoint (.pth holding the "
            f"state_dict, e.g. torch.save(torchvision.models.{arch}("
            f"weights='IMAGENET1K_V1').state_dict(), 'init.pth') on a "
            f"machine with torchvision); sm3x_torch loads it as it is, "
            f"without its fc.* keys.")

    for d in _search_dirs():
        cand = os.path.join(d, spec.filename)
        if os.path.isfile(cand):
            verify_weight_file(cand, spec)
            return cand
    raise FileNotFoundError(
        f"--arch-weights {arch}/{name} maps to {spec.filename} "
        f"(sha256 {spec.sha256_prefix}..., {spec.num_params:,} params, "
        f"ImageNet acc@1 {spec.acc1}); not found in "
        f"{_search_dirs()}. Nothing is downloaded here: on a "
        f"connected machine run\n    curl -LO {spec.url}\nthen stage the "
        f"file in $SM3X_WEIGHTS_DIR or ~/.cache/sm3x_weights/.")
