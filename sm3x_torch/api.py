"""The public inference API (counterpart of sm3x/api.py; the root
`inference_torch.py` is its script).

    model = build_evaluator()                       # the released shape
    load_weights(model, "best_finetune.pth", device="cuda")
    preds = predict_fn(model)(derm, clinic)         # 8 logit tensors

`predict_fn` takes NHWC float batches, as the reference does, and runs an
`eval()`, `inference_mode` forward on the device the weights are on. As in
the JAX package (`dtype=jnp.bfloat16`), the encoders run in bf16 by default
(`amp=True`: bf16 autocast) and the head in float32; `amp=False` runs the
whole model in float32.
"""

from __future__ import annotations

import torch

from sm3x_torch import NUM_CLASSES
from sm3x_torch.models.mlc import MLCModel
from sm3x_torch.utils.checkpoint import load_pretrained_state


def build_evaluator(arch="resnet50", mlc_proj_dim=512, num_labels=8,
                    l2_norm=False, num_heads=1, sa_dim_ff=128, sa_dropout=0.1,
                    amp=True, img_size=224) -> MLCModel:
    """The released configuration: dual extractor, v4 projectors, one
    transformer layer, prototype heads with a bias; the encoders under bf16
    autocast unless `amp=False`."""
    return MLCModel(
        arch=arch, proj_dim=mlc_proj_dim, num_labels=num_labels,
        mlc_proj="v4", l2_norm=l2_norm, n_heads=num_heads,
        sa_dim_ff=sa_dim_ff, sa_dropout=sa_dropout, use_prototype_bias=True,
        num_classes=tuple(NUM_CLASSES), amp=amp, img_size=img_size)


def load_weights(model: MLCModel, pretrain_path: str,
                 device="cuda") -> MLCModel:
    """Load a `.pth` strictly into `model` and move it to `device`: a
    `best_eval.pth` of the port's eval stage or a released checkpoint
    (`module.` prefixes, `encoder.` inside the extractor keys or stripped).
    Batch-norm step counts, which no forward reads, may be absent."""
    state = load_pretrained_state(pretrain_path)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state.setdefault(k, v)
    model.load_state_dict(state, strict=True)
    model.to(device)
    if torch.device(device).type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model.eval()


def predict_fn(model: MLCModel):
    """(derm, clinic) NHWC float batches -> list of 8 logit tensors, on the
    model's device."""

    @torch.inference_mode()
    def fwd(derm, clinic):
        dev = next(model.parameters()).device
        derm = torch.as_tensor(derm, dtype=torch.float32, device=dev)
        clinic = torch.as_tensor(clinic, dtype=torch.float32, device=dev)
        return model(derm, clinic)[1]

    return fwd


__all__ = ["build_evaluator", "load_weights", "predict_fn"]
