"""How `correct` is decided for a training cell: the program's first steps
against the reference's, by the numbers below, each under the limit that
the cell's file states.

  loss_gap     the largest over the checked steps of |L - L_ref| / |L_ref|
  proj_gap     |Z - Z_ref| / |Z_ref| of the first step's projections, all
               rows of every view, intra and cross, as one tensor
  grad_gap     the worst leaf of | |g| - |g_ref| | / max(|g_ref|, median)
               for the first gradient, the median over the leaves
  change_gap   the same of the parameters' change over the checked steps,
               over the leaves whose reference gradient is at least a
               thousandth of the median leaf's (the others move under Adam
               by round-off alone)
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

KEPT = 1e-3


@dataclasses.dataclass
class Readings:
    """What a side's first steps give the comparison."""
    losses: list     # each checked step's loss
    grad: dict       # leaf -> |first gradient|
    change: dict     # leaf -> |parameters after the checked steps - before|
    proj: object     # the first step's projections, one (rows, P) tensor


def projections(out: dict) -> torch.Tensor:
    """A dual encoder's projections as one tensor: the derm views', the
    clinic views', then each cross projection."""
    return torch.cat([out["derm_z"], out["clinic_z"], *out["cross_derm_z"],
                      *out["cross_clinic_z"]])


def worst_leaf(prog: dict, ref: dict, names=None) -> tuple:
    names = list(ref) if names is None else names
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def gaps(prog, ref) -> dict:
    """{number: (value, what it was read at)}."""
    loss = [abs(a - b) / abs(b) for a, b in zip(prog.losses, ref.losses)]
    if len(loss) != len(ref.losses) or set(prog.grad) != set(ref.grad):
        raise ValueError("the program and the reference read different "
                         "steps or leaves")
    med = statistics.median(ref.grad.values())
    kept = [n for n in ref.grad if ref.grad[n] >= KEPT * med]
    k = max(range(len(loss)), key=loss.__getitem__)
    proj = float((prog.proj - ref.proj).norm() / ref.proj.norm())
    return {"loss_gap": (loss[k], f"step {k + 1}"),
            "proj_gap": (proj, "step 1"),
            "grad_gap": worst_leaf(prog.grad, ref.grad),
            "change_gap": worst_leaf(prog.change, ref.change, kept)}


def judge(found: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}): each number under its
    limit; a missing or non-finite one is not."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = found[name][0]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, checks
