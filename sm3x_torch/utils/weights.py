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

`simclr_state_dict`, `simclr_skin_plain_state_dict`,
`simclr_skin_v2_state_dict` and `trimodal_state_dict` carry the model
variants no CLI reaches and the tri-modal model, `conv_ws_state_dict` the
dormant weight-standardised convolutions, each in the module layout of its
port class.

`mlc_state_dict` does the same for the stage-2 model, in the layout of
`export_mlc_model`, which strict-loads into `sm3x_torch.models.mlc.MLCModel`,
and `baseline_state_dict` for `sm3x_torch.models.baseline.Baseline` and
`SingleBaseline` (bare backbones and `classifier.{i}` heads).
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
    kernel (H, Dh, dim) -> (dim, H * Dh). A V-MoE tree (a block with a
    `moe` subtree) is refused: the port's V-MoE (sm3x_torch.models.vmoe)
    has no Flax counterpart whose layout this could follow."""
    moe = sorted(k for k, v in params.items()
                 if k.startswith("block") and "moe" in v)
    if moe:
        raise ValueError(
            f"a V-MoE tree ({', '.join(moe)} hold expert layers): no Flax "
            f"weight mapping exists for the port's V-MoE encoders; start "
            f"them from the seed or from a checkpoint the port wrote")
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


def branch_state_dict(params: dict, stats: dict, prefix: str) -> StateDict:
    """One `SimCLRBranch` (ResNet or ViT encoder, told apart by the tree; a
    ViT has no batch statistics) and its projector."""
    sd: StateDict = {}
    enc = params["encoder"]
    if "patch_embed" in enc:
        sd.update(vit_state_dict(enc, f"{prefix}encoder."))
    else:
        sd.update(resnet_state_dict(enc, stats["encoder"],
                                    f"{prefix}encoder."))
    sd.update(projector_state_dict(params["projector"], stats["projector"],
                                   f"{prefix}projector."))
    return sd


def simclr_skin_plain_state_dict(params: dict, stats: dict) -> StateDict:
    """`SimCLRSkin`: the derm and clinic branches."""
    sd: StateDict = {}
    for mod in ("derm_backbone", "clinic_backbone"):
        sd.update(branch_state_dict(params[mod], stats.get(mod, {}),
                                    f"{mod}."))
    return sd


def simclr_skin_state_dict(params: dict, stats: dict) -> StateDict:
    """Stage-1 model (V3 or V32, ResNet or ViT encoders)."""
    sd = simclr_skin_plain_state_dict(params, stats)
    if "cross_proj" in params:
        sd.update(projector_state_dict(params["cross_proj"],
                                       stats["cross_proj"], "cross_proj."))
    else:
        for i, name in enumerate(("cross_proj_derm", "cross_proj_clinic")):
            sd.update(projector_state_dict(params[name], stats[name],
                                           f"cross_proj.{i}."))
    return sd


def simclr_state_dict(params: dict, stats: dict) -> StateDict:
    """`SimCLR`: its one branch under `branch.`."""
    return branch_state_dict(params["branch"], stats.get("branch", {}),
                             "branch.")


def simclr_skin_v2_state_dict(params: dict, stats: dict) -> StateDict:
    """`SimCLRSkinV2` of any fusion: the branches and the cross projector,
    whose input width (2 x feat, or feat for "add") comes with the tree."""
    sd = simclr_skin_plain_state_dict(params, stats)
    sd.update(projector_state_dict(params["cross_proj"], stats["cross_proj"],
                                   "cross_proj."))
    return sd


def trimodal_state_dict(params: dict, stats: dict) -> StateDict:
    """`TriModalSimCLR`: the branches, the metadata encoder (each `Embed`
    table copied, fc1 / fc2 transposed) and the three cross projectors."""
    sd = simclr_skin_plain_state_dict(params, stats)
    meta = params["meta_encoder"]
    fields = sorted(int(k[len("embed"):]) for k in meta
                    if k.startswith("embed"))
    for i in fields:
        sd[f"meta_encoder.embeds.{i}.weight"] = _np(
            meta[f"embed{i}"]["embedding"])
    _dense(sd, "meta_encoder.fc1", meta["fc1"])
    _dense(sd, "meta_encoder.fc2", meta["fc2"])
    for name in ("cross_proj_derm", "cross_proj_clinic", "cross_proj_meta"):
        sd.update(projector_state_dict(params[name], stats[name],
                                       f"{name}."))
    return sd


def conv_ws_state_dict(params: dict) -> StateDict:
    """`ConvWS` / `ConvAWS`: the kernel HWIO -> OIHW, the bias, and the
    adaptive scale and shift (1, 1, 1, O) -> (O, 1, 1, 1)."""
    sd: StateDict = {"weight": _conv_w(params["kernel"])}
    if "bias" in params:
        sd["bias"] = _np(params["bias"])
    for name in ("ws_gamma", "ws_beta"):
        if name in params:
            sd[name] = _conv_w(params[name])
    return sd


# MultiLabelProjector variant -> (linears, batch norms), each (Flax name,
# index in the head's Sequential); the last batch norm has no scale or bias
_MLP_LAYOUT = {
    "v0": ([], []),
    "v1": ([("fc1", 0), ("fc2", 3), ("fc3", 6)],
           [("bn1", 1), ("bn2", 4), ("bn3", 7)]),
    "v2": ([("fc1", 0), ("fc2", 3)], [("bn1", 1), ("bn2", 4)]),
    "v3": ([("fc1", 0)], [("bn1", 1)]),
    "v4": ([("fc1", 0)], []),
}


def multilabel_projector_state_dict(params: dict, stats, variant: str = "v4",
                                    prefix: str = "projectors.") -> StateDict:
    """The vmapped heads, stacked (H, ...) in the Flax tree, one Sequential
    a head."""
    sd: StateDict = {}
    lins, bns = _MLP_LAYOUT[variant]
    if not lins:
        return sd
    heads_p = params["heads"]
    heads_s = (stats or {}).get("heads", {})
    num_labels = heads_p[lins[0][0]]["kernel"].shape[0]
    for h in range(num_labels):
        for name, idx in lins:
            sd[f"{prefix}{h}.{idx}.weight"] = _lin_w(heads_p[name]["kernel"][h])
            if "bias" in heads_p[name]:
                sd[f"{prefix}{h}.{idx}.bias"] = _np(heads_p[name]["bias"][h])
        for name, idx in bns:
            affine = heads_p.get(name)
            _bn(sd, f"{prefix}{h}.{idx}",
                None if affine is None else {k: v[h] for k, v in affine.items()},
                {k: v[h] for k, v in heads_s[name].items()})
    return sd


def transformer_layer_state_dict(params: dict,
                                 prefix: str = "mlc_sa.") -> StateDict:
    sd: StateDict = {}
    attn = params["self_attn"]
    sd[prefix + "self_attn.in_proj_weight"] = _lin_w(attn["in_proj"]["kernel"])
    sd[prefix + "self_attn.in_proj_bias"] = _np(attn["in_proj"]["bias"])
    _dense(sd, prefix + "self_attn.out_proj", attn["out_proj"])
    _dense(sd, prefix + "linear1", params["linear1"])
    _dense(sd, prefix + "linear2", params["linear2"])
    _ln(sd, prefix + "norm1", params["norm1"])
    _ln(sd, prefix + "norm2", params["norm2"])
    return sd


def mlc_state_dict(params: dict, stats: dict,
                   variant: str = "v4") -> StateDict:
    """Stage-2 / inference model (`MLCModel` with ResNet encoders): the two
    extractor encoders, the per-label projectors of `variant`, the
    transformer layer and the prototypes (a bias only in the eval
    variant)."""
    sd: StateDict = {}
    for mod in ("derm_backbone", "clinic_backbone"):
        sd.update(resnet_state_dict(params["extractor"][mod]["encoder"],
                                    stats["extractor"][mod]["encoder"],
                                    f"extractor.{mod}.encoder."))
    head_p, head_s = params["head"], stats.get("head", {})
    sd.update(multilabel_projector_state_dict(
        head_p.get("projectors", {}), head_s.get("projectors"), variant,
        "projectors.projectors."))
    sd.update(transformer_layer_state_dict(head_p["mlc_sa"], "mlc_sa."))
    for name, leaf in head_p["prototypes"].items():
        key = f"prototypes.{int(name[len('proto'):])}"
        sd[f"{key}.weight"] = _lin_w(leaf["kernel"])
        if "bias" in leaf:
            sd[f"{key}.bias"] = _np(leaf["bias"])
    return sd


def baseline_state_dict(params: dict, stats: dict) -> StateDict:
    """`Baseline` / `SingleBaseline` with ResNet backbones: each backbone
    the tree holds, then the heads, linear (`classifier/head{i}`) or MLP
    (`classifier_{i}` with fc1, an optional bn, fc2)."""
    sd: StateDict = {}
    for mod in ("derm_backbone", "clinic_backbone"):
        if mod in params:
            sd.update(resnet_state_dict(params[mod], stats[mod], f"{mod}."))
    if "classifier" in params:
        for name, leaf in params["classifier"].items():
            _dense(sd, f"classifier.{int(name[len('head'):])}", leaf)
        return sd
    for name, leaf in params.items():
        if not name.startswith("classifier_"):
            continue
        key = f"classifier.{int(name[len('classifier_'):])}"
        _dense(sd, f"{key}.fc1", leaf["fc1"])
        _dense(sd, f"{key}.fc2", leaf["fc2"])
        if "bn" in leaf:
            _bn(sd, f"{key}.bn", leaf["bn"], stats[name]["bn"])
    return sd


def to_tensors(sd: StateDict, device="cpu") -> dict:
    """numpy state dict -> torch tensors on `device`."""
    import torch

    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in sd.items()}
