"""The stage `ssl_moe`: stage 1 (dual-encoder NT-Xent) on encoders with
sparse experts (V-MoE), driven through the port as `ssl` drives it, plus
what the expert layers add.

The program's run is `ssl`'s (`SSLRun`), and its window also sums the
routing's drop counts that the trainer reads back with each epoch's
losses: `moe_dropped` of `moe_assignments` over the window's first
`READ_EPOCHS` epochs (the routers learn through the window and drop more
as they do, so a fixed count of epochs keeps the share apart from the
step's speed), and `moe_traced_dropped` of `moe_traced_assignments` over
the traced epochs, the routing of the steps whose kernels are timed.
`step_shapes` adds `moe`, one routing group's shapes and K5's launches a
step, and the FLOPs count each token's k expert passes.

The reference is `reference.train`'s (float32, TF32 off, AdamW over the
checked steps), computed in blocks so that a V-MoE-B/16 pair fits one card
beside its optimizer: for each step, each of the four encoder calls (a
routing group: one view of one modality) runs forward without grad; the
projectors, the loss and its gradient with respect to the four features
follow; then each call runs again with grad on the same noise and
backpropagates its features' gradient and its share of the aux loss
(lambda x its blocks' mean / 4). That is the arithmetic of one unblocked
pass up to the order of the sums (`first_steps(..., blocked=False)`).
The router noise is drawn by the rule the program states
(`reference.vmoe.noises`).

The configuration's `moe.router_init` "zero" starts every router's weight
at zero on both sides (`start_routers`), so that the first steps route by
the noise alone: balanced, and the same choices in the program and the
reference. The program's change of a router is then read from zero, not
from the seeded draw that `ssl` reads the other leaves' change from.
"""

from __future__ import annotations

import torch

from portbench.harness.checks import Readings, projections
from portbench.reference import nets, prng
from portbench.reference import vmoe as ref_vmoe
from portbench.reference.train import _tf32, build_model, views
from portbench.stages import ssl

CALLS = 4      # encoder calls a step: two views a modality
ROUTER = ".moe.router.weight"
READ_EPOCHS = 12   # the window's first epochs whose drop share is read


def start_routers(cell, model) -> list:
    """Zero the routers' weights of `model` where the configuration starts
    them at zero (`moe.router_init` "zero"); the (name, weight) of those
    zeroed."""
    if cell.config["moe"].get("router_init") != "zero":
        return []
    routers = [(n, p) for n, p in model.named_parameters()
               if n.endswith(ROUTER)]
    with torch.no_grad():
        for _, p in routers:
            p.zero_()
    return routers


def step_shapes(cell) -> dict:
    """`ssl`'s shapes, and `moe`: one routing group's (groups a step, N
    tokens, E experts, k choices, C slots an expert, width D) and K5's
    launches a step of each of its four kernels."""
    c, m = cell.config, cell.config["moe"]
    out = ssl.step_shapes(cell)
    tokens = cell.batch * ((c["img_size"] // c["patch"]) ** 2 + 1)
    cap = max(1, int(round(m["k"] * tokens * m["capacity_ratio"]
                           / m["experts"])))
    out["moe"] = dict(groups=CALLS, n=tokens, experts=m["experts"], k=m["k"],
                      cap=cap, d=c["hidden"],
                      launches=CALLS * len(m["blocks"]))
    return out


class MoERun(ssl.SSLRun):
    """`SSLRun`, whose window also carries the drop counts of its epochs."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.routed = []     # (dropped, assignments) of each window epoch
        self.traced = []     # the same of each traced epoch
        self.routers = []

    def build(self) -> None:
        super().build()
        self.routers = start_routers(self.cell, self.trainer.model)

    def _first_step_readings(self, out) -> None:
        super()._first_step_readings(out)
        if self.calls == self.checked:
            for name, p in self.routers:      # their change is from zero
                self.first.change[name] = float(p.detach().norm())

    def _epoch(self, epoch: int) -> dict:
        stat = super()._epoch(epoch)
        if self.window_calls is not None:
            (self.routed if self.tracer is None else self.traced).append(
                (stat.get("moe_dropped", 0.0),
                 stat.get("moe_assignments", 0.0)))
        return stat

    def window(self, seconds: float, trace: bool = False) -> dict:
        win = super().window(seconds, trace)
        for key, epochs in (("moe", self.routed[:READ_EPOCHS]),
                            ("moe_traced", self.traced)):
            win[f"{key}_dropped"] = sum(d for d, _ in epochs)
            win[f"{key}_assignments"] = sum(a for _, a in epochs)
        return win


Run = MoERun


def _encode(model, m: int, views_m, noise_m, grad: bool):
    """Modality m's encoder over its two views: [(feature, aux, dropped)]."""
    enc = model.encoders()[m]
    with torch.set_grad_enabled(grad):
        return [enc(v, n) for v, n in zip(views_m, noise_m)]


def _head(model, feats) -> dict:
    """The projections of the v3.2 loss from the four features
    (`nets.DualEncoder.forward` past the encoders)."""
    out = {}
    for name, br, f, k in (("derm", model.derm_backbone, feats[0], 0),
                           ("clinic", model.clinic_backbone, feats[1], 1)):
        out[f"{name}_z"] = br.projector(torch.cat(f))
        out[f"cross_{name}_z"] = [model.cross_proj[k](x) for x in f]
    return out


def _step(cell, model, views_all, noise_all, blocked: bool) -> tuple:
    """One step's forward and backward into the parameters' `.grad`:
    (loss, projections)."""
    c = cell.config
    lam = c["moe"]["aux_weight"]
    if not blocked:
        runs = [_encode(model, m, views_all[m], noise_all[m], True)
                for m in range(2)]
        out = _head(model, [[f for f, _, _ in r] for r in runs])
        aux = torch.stack([a for r in runs for _, a, _ in r]).mean()
        loss = nets.ssl_loss(out, c["temperature"], c["world_size"]) + lam * aux
        loss.backward()
        return loss.detach(), projections(out).detach()
    feats = [[f.detach().requires_grad_() for f, _, _ in
              _encode(model, m, views_all[m], noise_all[m], False)]
             for m in range(2)]
    out = _head(model, feats)
    ssl_part = nets.ssl_loss(out, c["temperature"], c["world_size"])
    ssl_part.backward()
    aux_sum = 0.0
    for m in range(2):
        for v in range(2):
            f, aux, _ = _encode(model, m, [views_all[m][v]],
                                [noise_all[m][v]], True)[0]
            ((f * feats[m][v].grad).sum() + lam * aux / CALLS).backward()
            aux_sum = aux_sum + aux.detach()
            del f, aux
    loss = ssl_part.detach() + lam * (aux_sum / CALLS)
    return loss, projections(out).detach()


def first_steps(cell, split: dict, seed: int, device,
                numerics: str = "float32", blocked: bool = True) -> Readings:
    """The reference's readings of the cell's checked steps (see the
    module's docstring); `numerics="fp8"` the control, as in
    `reference.train`."""
    c, t = cell.config, cell.traffic
    m = c["moe"]
    lowered = numerics != "float32"
    tf32 = _tf32(lowered, lowered)
    try:
        model = build_model(cell, seed, device)
        start_routers(cell, model)
        if lowered:
            for enc in model.encoders():
                nets.set_numerics(enc, nets.Numerics(numerics))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = torch.optim.AdamW(model.parameters(), lr=c["lr"],
                                betas=(0.9, 0.999), eps=c["adam_eps"],
                                weight_decay=c["wd"])
        tokens = cell.batch * ((c["img_size"] // c["patch"]) ** 2 + 1)
        order = prng.epoch_order(t["cases"], seed, 0)
        losses, grad, proj = [], {}, None
        for k in range(int(t["checked_steps"])):
            rows = prng.batch_rows(order, cell.batch, k)
            batch = {f: torch.from_numpy(split[f][rows]).to(device)
                     for f in ("derm", "derm_hw", "clinic", "clinic_hw")}
            s = prng.step_seed(seed, 0, k)
            views_all = [views(cell, prng.fold_in(s, 0), batch["derm"],
                               batch["derm_hw"]),
                         views(cell, prng.fold_in(s, 1), batch["clinic"],
                               batch["clinic_hw"])]
            noise_all = [ref_vmoe.noises(g, 2, tokens, m["experts"],
                                         len(m["blocks"]), device)
                         for g in ref_vmoe.router_generators(s, device)]
            opt.zero_grad(set_to_none=True)
            loss, out_proj = _step(cell, model, views_all, noise_all,
                                   blocked)
            if k == 0:
                grad = {n: p.grad.norm() for n, p in model.named_parameters()}
                proj = out_proj.float().cpu()
            opt.step()
            losses.append(loss)
            del views_all, noise_all
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


reference = first_steps
