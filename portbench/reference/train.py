"""The reference's first steps of a stage-1 cell.

From the benchmark's inputs alone (the split's canvases, the seed, the
weights the benchmark makes from it) it works out the epoch order, each
step's rows and seeds and every augmented view, then trains the plain
dual encoder for the checked steps with AdamW (betas 0.9 / 0.999, the
configuration's lr, eps and decoupled weight decay) and returns what is
compared: each step's loss, each leaf's first gradient and each leaf's
change over the steps.

`numerics="float32"` is the reference: float32 throughout, TF32 off.
`numerics="fp8"` is the control: the encoders' products in fp8 and the
projectors' and the loss's in TF32, one step below what the
configuration states for each.
"""

from __future__ import annotations

import torch

from portbench.harness.checks import Readings, projections
from portbench.harness.inputs import load_weights
from portbench.reference import augment, nets, prng


def _tf32(matmul: bool, cudnn: bool) -> tuple:
    """Set TF32 for matmuls and cuDNN; returns the settings before."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    return before


def views(cell, seed: int, canvases, valid_hw) -> list:
    """The two views of one modality under `seed`: view i draws from
    `fold_in(seed, i)`, at the model's size and the recipe's scale."""
    c = cell.config
    size = c["img_size"]
    aug = augment.Aug(out_size=(size, size), rrc_scale=(0.5, 1.0))
    return [augment.view(prng.fold_in(seed, v), canvases, valid_hw,
                         tuple(c["mean"]), tuple(c["std"]), aug)
            for v in range(2)]


def build_model(cell, seed: int, device) -> nets.DualEncoder:
    c = cell.config
    model = nets.DualEncoder(lambda: cell.model.encoder(c), c["proj_dim"])
    model.to(device)
    load_weights(model, seed, device, c.get("init_constants"))
    return model


def first_steps(cell, split: dict, seed: int, device,
                numerics: str = "float32") -> Readings:
    """The reference's readings of the cell's checked steps."""
    c, t = cell.config, cell.traffic
    lowered = numerics != "float32"
    tf32 = _tf32(lowered, lowered)
    try:
        model = build_model(cell, seed, device)
        if lowered:
            for enc in model.encoders():
                nets.set_numerics(enc, nets.Numerics(numerics))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = torch.optim.AdamW(model.parameters(), lr=c["lr"],
                                betas=(0.9, 0.999), eps=c["adam_eps"],
                                weight_decay=c["wd"])
        order = prng.epoch_order(t["cases"], seed, 0)
        losses, grad = [], {}
        for k in range(int(t["checked_steps"])):
            rows = prng.batch_rows(order, cell.batch, k)
            batch = {f: torch.from_numpy(split[f][rows]).to(device)
                     for f in ("derm", "derm_hw", "clinic", "clinic_hw")}
            s = prng.step_seed(seed, 0, k)
            d = views(cell, prng.fold_in(s, 0), batch["derm"],
                      batch["derm_hw"])
            cl = views(cell, prng.fold_in(s, 1), batch["clinic"],
                       batch["clinic_hw"])
            opt.zero_grad(set_to_none=True)
            out = model(d, cl)
            loss = nets.ssl_loss(out, c["temperature"], c["world_size"])
            loss.backward()
            if k == 0:
                grad = {n: p.grad.norm() for n, p in model.named_parameters()}
                proj = projections(out).detach().float().cpu()
            opt.step()
            losses.append(loss.detach())
            del d, cl, loss, out
        change = {n: (p.detach() - before[n]).norm()
                  for n, p in model.named_parameters()}
        names = list(grad)
        return Readings([float(x) for x in losses],
                        dict(zip(names, torch.stack(
                            [grad[n] for n in names]).tolist())),
                        dict(zip(names, torch.stack(
                            [change[n] for n in names]).tolist())), proj)
    finally:
        _tf32(*tf32)
