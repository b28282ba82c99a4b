"""Stage-1 SSL loss assembly (counterpart of sm3x/losses/ssl.py).

  style 0 (v3/v32):     cross = 0.5 L(cd1, cc1) + 0.5 L(cd2, cc2)
  style 1 (v311/v321):  cross = 0.5 L(cd1, cc2) + 0.5 L(cd2, cc1)
  style 2 (v312/v322):  cross = 0.25 * sum over the 4 view pairs
  total = w_derm L_derm + w_clinic L_clinic + cross

`groups` keeps NT-Xent negatives local to each of `groups` equal
sub-batches, the reference's per-device negatives under DDP.

Every term and group is one problem of one NT-Xent call
(sm3x_torch.ops.ntxent_cuda.ntxent_problems_loss): on CUDA one forward and
one backward launch of kernel K2 per loss, where the JAX package loops
over terms and groups.

Across `world` processes (each holding its rows of the global batch of
every projection): where the processes divide the groups, each holds
groups / world whole groups and computes them alone, and the returned
loss is its share (the mean over ranks, which DDP's average of gradients
takes, is the global loss); otherwise (--negatives global included) the
projections of all ranks are gathered, with a gradient that goes back to
each row's owner, and every rank computes the global loss of all groups.
"""

from __future__ import annotations

import torch

from sm3x_torch.ops.ntxent import group_problems
from sm3x_torch.ops.ntxent_cuda import ntxent_problems_loss
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


def ssl_loss(outputs: dict, style: int, temperature: float, groups: int = 1,
             modality_weights=(1.0, 1.0), world: int = 1):
    """outputs: the dict of SimCLRSkinV3.forward, of this rank's rows when
    `world` > 1. Returns (total, {"derm": .., "clinic": .., "cross": ..}):
    this rank's share of the loss where every rank holds whole groups
    (`local_groups`), the global loss otherwise."""
    b = outputs["derm_z"].shape[0] // 2
    terms = [(outputs["derm_z"][:b], outputs["derm_z"][b:], 1.0),
             (outputs["clinic_z"][:b], outputs["clinic_z"][b:], 1.0)]
    terms += _pairs(outputs, style)
    views = [z for z1, z2, _ in terms for z in (z1, z2)]
    if local_groups(groups, world):
        here = groups // world
    else:
        # (b, 2 x terms, D) of every rank in one gather, in rank order
        here = groups
        views = gather_rows_autograd(torch.stack(views, dim=1)).unbind(1)
    z = torch.cat([group_problems(views[2 * k], views[2 * k + 1], here)
                   for k in range(len(terms))])
    per_term = ntxent_problems_loss(z, temperature).view(len(terms), here)
    per_term = per_term.mean(dim=1)
    derm, clinic = per_term[0], per_term[1]
    cross = sum(w * per_term[2 + k] for k, (_, _, w) in enumerate(terms[2:]))
    total = modality_weights[0] * derm + modality_weights[1] * clinic + cross
    return total, {"derm": derm, "clinic": clinic, "cross": cross}


def local_groups(groups: int, world: int) -> bool:
    """Each of `world` ranks holds `groups / world` whole groups."""
    return groups % world == 0
