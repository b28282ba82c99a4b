"""Weight bridge: Flax `params` / `batch_stats` trees (nested dicts of numpy
arrays) -> the port's state dict. Numpy only.

The key layout is the one `sm3x.utils.torch_export.export_simclr_skin`
writes, which is the port's own module layout, so the result strict-loads
into `sm3x_torch.models.simclr.SimCLRSkinV3`:
  * convs HWIO -> OIHW, linears (in, out) -> (out, in);
  * BatchNorm scale/bias -> weight/bias, mean/var -> running_mean/var, and
    a zero `num_batches_tracked`.

The ViTs have no counterpart in `torch_export`; their layout is the port's
own, named after the Flax tree (`vit_state_dict`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

StateDict = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _lin_w(w) -> np.ndarray:
    return np.ascontiguousarray(_np(w).T)


def _conv_w(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (3, 2, 0, 1)))


def _bn(sd: StateDict, key: str, params, stats) -> None:
    """params=None: a stat-only (affine=False) BatchNorm."""
    if params is not None:
        sd[f"{key}.weight"] = _np(params["scale"])
        sd[f"{key}.bias"] = _np(params["bias"])
    sd[f"{key}.running_mean"] = _np(stats["mean"])
    sd[f"{key}.running_var"] = _np(stats["var"])
    sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)


def _blocks(params: dict):
    """(stage, block) of every `layer{stage}_{block}` entry, in order."""
    ids = [tuple(int(v) for v in k[len("layer"):].split("_"))
           for k in params if k.startswith("layer")]
    return sorted(ids)


def resnet_state_dict(params: dict, stats: dict,
                      prefix: str = "") -> StateDict:
    """Any ResNet of the family: the blocks and their convs are read from
    the tree."""
    sd: StateDict = {}
    sd[prefix + "conv1.weight"] = _conv_w(params["conv1"]["kernel"])
    _bn(sd, prefix + "bn1", params["bn1"], stats["bn1"])
    for stage, b in _blocks(params):
        key = f"{prefix}layer{stage}.{b}"
        bp, bs = params[f"layer{stage}_{b}"], stats[f"layer{stage}_{b}"]
        n_convs = sum(1 for k in bp if k.startswith("cb"))
        for c in range(1, n_convs + 1):
            cell, cell_s = bp[f"cb{c}"], bs[f"cb{c}"]
            sd[f"{key}.conv{c}.weight"] = _conv_w(cell["conv"]["kernel"])
            _bn(sd, f"{key}.bn{c}", cell["bn"], cell_s["bn"])
        if "down" in bp:
            sd[f"{key}.downsample.0.weight"] = _conv_w(
                bp["down"]["conv"]["kernel"])
            _bn(sd, f"{key}.downsample.1", bp["down"]["bn"],
                bs["down"]["bn"])
    if "fc" in params:
        sd[prefix + "fc.weight"] = _lin_w(params["fc"]["kernel"])
        sd[prefix + "fc.bias"] = _np(params["fc"]["bias"])
    return sd


def _ln(sd: StateDict, key: str, params) -> None:
    sd[f"{key}.weight"] = _np(params["scale"])
    sd[f"{key}.bias"] = _np(params["bias"])


def _dense(sd: StateDict, key: str, params) -> None:
    sd[f"{key}.weight"] = _lin_w(params["kernel"])
    sd[f"{key}.bias"] = _np(params["bias"])


def vit_state_dict(params: dict, prefix: str = "") -> StateDict:
    """Any ViT of the family (`sm3x_torch.models.vit.ViT`): the blocks are
    read from the tree. Attention projections: q/k/v kernels (dim, H, Dh)
    -> Linear (H * Dh, dim) and biases (H, Dh) -> (H * Dh,); the output
    kernel (H, Dh, dim) -> (dim, H * Dh)."""
    sd: StateDict = {}
    sd[prefix + "patch_embed.weight"] = _conv_w(params["patch_embed"]["kernel"])
    sd[prefix + "patch_embed.bias"] = _np(params["patch_embed"]["bias"])
    sd[prefix + "cls"] = _np(params["cls"])
    sd[prefix + "pos_embed"] = _np(params["pos_embed"])
    blocks = sorted(int(k[len("block"):]) for k in params
                    if k.startswith("block"))
    for i in blocks:
        bp, key = params[f"block{i}"], f"{prefix}block{i}"
        _ln(sd, f"{key}.ln1", bp["ln1"])
        for name in ("query", "key", "value"):
            w = _np(bp["attn"][name]["kernel"])
            sd[f"{key}.attn.{name}.weight"] = np.ascontiguousarray(
                w.reshape(w.shape[0], -1).T)
            sd[f"{key}.attn.{name}.bias"] = _np(
                bp["attn"][name]["bias"]).reshape(-1)
        w = _np(bp["attn"]["out"]["kernel"])
        sd[f"{key}.attn.out.weight"] = np.ascontiguousarray(
            w.reshape(-1, w.shape[-1]).T)
        sd[f"{key}.attn.out.bias"] = _np(bp["attn"]["out"]["bias"])
        _ln(sd, f"{key}.ln2", bp["ln2"])
        _dense(sd, f"{key}.fc1", bp["fc1"])
        _dense(sd, f"{key}.fc2", bp["fc2"])
    _ln(sd, prefix + "ln_final", params["ln_final"])
    if "fc" in params:
        _dense(sd, prefix + "fc", params["fc"])
    return sd


def projector_state_dict(params: dict, stats: dict,
                         prefix: str = "") -> StateDict:
    """SSLProjector: Sequential indices 0, 1, 3, 4, 6, 7."""
    sd: StateDict = {}
    for i, (fc, bn) in enumerate((("fc1", "bn1"), ("fc2", "bn2"),
                                  ("fc3", "bn3"))):
        sd[f"{prefix}{3 * i}.weight"] = _lin_w(params[fc]["kernel"])
        _bn(sd, f"{prefix}{3 * i + 1}", params.get(bn), stats[bn])
    return sd


def simclr_skin_state_dict(params: dict, stats: dict) -> StateDict:
    """Stage-1 model (V3 or V32, ResNet or ViT encoders, told apart by the
    tree; a ViT has no batch statistics)."""
    sd: StateDict = {}
    for mod in ("derm_backbone", "clinic_backbone"):
        enc, prefix = params[mod]["encoder"], f"{mod}.encoder."
        if "patch_embed" in enc:
            sd.update(vit_state_dict(enc, prefix))
        else:
            sd.update(resnet_state_dict(enc, stats[mod]["encoder"], prefix))
        sd.update(projector_state_dict(params[mod]["projector"],
                                       stats[mod]["projector"],
                                       prefix=f"{mod}.projector."))
    if "cross_proj" in params:
        sd.update(projector_state_dict(params["cross_proj"],
                                       stats["cross_proj"], "cross_proj."))
    else:
        for i, name in enumerate(("cross_proj_derm", "cross_proj_clinic")):
            sd.update(projector_state_dict(params[name], stats[name],
                                           f"cross_proj.{i}."))
    return sd


def to_tensors(sd: StateDict, device="cpu") -> dict:
    """numpy state dict -> torch tensors on `device`."""
    import torch

    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in sd.items()}
