"""Reading `.pth` checkpoints (counterpart of the torch side of
sm3x/utils/checkpoint.py and of the key conventions in
sm3x/utils/torch_convert.py:33-56).

The port's models keep the released checkpoints' key layout, so loading is
key surgery and no conversion:
  * a file is the training-state wrapper `{"epoch", "state_dict", ...}` or
    a bare state dict; DataParallel's `module.` prefix is dropped;
  * the MLC model's extractor keys come as `extractor.{mod}.encoder.*`
    (the released files and the port's own) or with `encoder.` already
    stripped (`extractor.{mod}.conv1.*`), since the reference's loader
    strips that substring from every key and so takes either;
  * a stage-1 file gives its two encoders and drops its projectors.
"""

from __future__ import annotations

import re
import shutil

import torch

MODALITIES = ("derm_backbone", "clinic_backbone")


def load_checkpoint_file(path: str) -> dict:
    """The whole file on the CPU: tensors, and the plain containers and
    numbers of an optimizer's state."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state_dict_file(path: str) -> dict:
    """The model's state dict of `path`, out of its wrapper if it has one,
    with a leading `module.` stripped from every key."""
    obj = load_checkpoint_file(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {re.sub(r"^module\.", "", k): v for k, v in obj.items()}


def load_pretrained_state(path: str) -> dict:
    """An MLC checkpoint (stage 2's `ckp_*.pth`, an eval stage's
    `best_eval.pth`, a released `best_*.pth`) in the port's native layout,
    `extractor.{mod}.encoder.*`, whichever of the two forms the file has."""
    out = {}
    for k, v in load_state_dict_file(path).items():
        for mod in MODALITIES:
            prefix = f"extractor.{mod}."
            if k.startswith(prefix) and not k.startswith(prefix + "encoder."):
                k = f"{prefix}encoder.{k[len(prefix):]}"
        out[k] = v
    return out


def load_encoder_state(path: str) -> dict:
    """The two encoders of a stage-1 `ckp_*.pth`, keyed `{mod}.encoder.*`
    as `DualExtractor` names them; the projectors of the SSL model are
    dropped."""
    prefixes = tuple(f"{mod}.encoder." for mod in MODALITIES)
    return {k: v for k, v in load_state_dict_file(path).items()
            if k.startswith(prefixes)}


def copy_best(src: str, dst: str) -> None:
    """Copy a checkpoint file to `dst` (the `best_eval.pth` convention)."""
    shutil.copyfile(src, dst)


def export_backbone(state: dict) -> dict:
    """Backbone-only export of a stage-1 or MLC state dict: the dual
    encoders stay, projectors and heads go."""
    keep = tuple(f"{scope}{mod}.encoder." for scope in ("", "extractor.")
                 for mod in MODALITIES)
    return {k: v for k, v in state.items() if k.startswith(keep)}
