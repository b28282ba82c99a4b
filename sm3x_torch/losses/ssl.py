"""Stage-1 SSL loss assembly (counterpart of sm3x/losses/ssl.py).

  style 0 (v3/v32):     cross = 0.5 L(cd1, cc1) + 0.5 L(cd2, cc2)
  style 1 (v311/v321):  cross = 0.5 L(cd1, cc2) + 0.5 L(cd2, cc1)
  style 2 (v312/v322):  cross = 0.25 * sum over the 4 view pairs
  total = w_derm L_derm + w_clinic L_clinic + cross [+ w_local L_local]

With multi-crop local views, L_local is the mean over the locals of each
one's NT-Xent against global view 1 of its modality. The tri-modal loss
(sm3x_torch.models.trimodal.trimodal_ssl_loss) goes through the same
`ntxent_terms`.

`groups` keeps NT-Xent negatives local to each of `groups` equal
sub-batches, the reference's per-device negatives under DDP.

Every term and group is one problem of one NT-Xent call (`ntxent_terms`,
through sm3x_torch.ops.ntxent_cuda.ntxent_problems_loss): on CUDA one forward and
one backward launch of kernel K2 per loss, where the JAX package loops
over terms and groups.

Across `world` ranks of the data axis (each holding its rows of the
global batch of every projection; the ranks of one model group hold the
same rows and compute the same loss): where the processes divide the
groups, each holds groups / world whole groups and computes them alone,
and the returned loss is its share (the mean over ranks, which DDP's
average of gradients takes, is the global loss); otherwise (--negatives global included) the
projections of all ranks are gathered, with a gradient that goes back to
each row's owner, and every rank computes the global loss of all groups.
"""

from __future__ import annotations

import torch

from sm3x_torch.ops.ntxent import group_problems
from sm3x_torch.ops.ntxent_cuda import ntxent_problems_loss
from sm3x_torch.core.mesh import data_group
from sm3x_torch.parallel.collectives import gather_rows_autograd


def _pairs(outputs: dict, style: int):
    """[(z1, z2, weight)] of the cross terms."""
    cd, cc = outputs["cross_derm_z"], outputs["cross_clinic_z"]
    if style == 0:
        return [(cd[0], cc[0], 0.5), (cd[1], cc[1], 0.5)]
    if style == 1:
        return [(cd[0], cc[1], 0.5), (cd[1], cc[0], 0.5)]
    if style == 2:
        return [(a, c, 0.25) for a in cd for c in cc]
    raise ValueError(f"style must be 0/1/2, got {style}")


def ntxent_terms(pairs, temperature: float, groups: int = 1,
                 world: int = 1) -> torch.Tensor:
    """[(z1, z2)] -> (terms,): each pair's NT-Xent, the mean over its
    groups, all pairs and groups in one `ntxent_problems_loss` call (on
    CUDA one K2f and one K2b launch). Across `world` ranks each holds its
    rows of every projection: its share of its own groups where it holds
    whole groups (`local_groups`), else the global value from the gathered
    rows."""
    views = [z for pair in pairs for z in pair]
    if local_groups(groups, world):
        here = groups // world
    else:
        # (b, 2 x terms, D) of every rank in one gather, in rank order
        here = groups
        views = gather_rows_autograd(torch.stack(views, dim=1),
                                     data_group()).unbind(1)
    z = torch.cat([group_problems(views[2 * k], views[2 * k + 1], here)
                   for k in range(len(pairs))])
    per_term = ntxent_problems_loss(z, temperature).view(len(pairs), here)
    return per_term.mean(dim=1)


def ssl_loss(outputs: dict, style: int, temperature: float, groups: int = 1,
             modality_weights=(1.0, 1.0), world: int = 1,
             local_weight: float = 1.0):
    """outputs: the dict of SimCLRSkinV3.forward, of this rank's rows when
    `world` > 1; with local views (multi-crop) each local contributes an
    NT-Xent against global view 1 of its modality, the mean of those terms
    weighted by `local_weight`. Returns (total, {"derm": .., "clinic": ..,
    "cross": .., ["local": ..]}): this rank's share of the loss where every
    rank holds whole groups (`local_groups`), the global loss otherwise."""
    b = outputs["derm_z"].shape[0] // 2
    cross = _pairs(outputs, style)
    pairs = [(outputs["derm_z"][:b], outputs["derm_z"][b:]),
             (outputs["clinic_z"][:b], outputs["clinic_z"][b:])]
    pairs += [(z1, z2) for z1, z2, _ in cross]
    for mod in ("derm", "clinic"):
        anchor = outputs[f"{mod}_z"][:b]
        pairs += [(lz, anchor) for lz in outputs.get(f"{mod}_local_z", ())]
    per_term = ntxent_terms(pairs, temperature, groups, world)
    derm, clinic = per_term[0], per_term[1]
    cross_loss = sum(w * per_term[2 + k] for k, (_, _, w) in enumerate(cross))
    total = (modality_weights[0] * derm + modality_weights[1] * clinic
             + cross_loss)
    parts = {"derm": derm, "clinic": clinic, "cross": cross_loss}
    if len(pairs) > 2 + len(cross):
        parts["local"] = per_term[2 + len(cross):].mean()
        total = total + local_weight * parts["local"]
    return total, parts


def local_groups(groups: int, world: int) -> bool:
    """Each of `world` ranks holds `groups / world` whole groups."""
    return groups % world == 0
