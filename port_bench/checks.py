"""The comparison that decides `correct`: the program's first steps against
the plain reference's over the same weights and inputs.

A driver gives, for the program and for the reference, the loss of each
compared step ("loss"), each leaf's norm of the first gradient as the
optimizer holds it after the first step ("grad") and each leaf's norm of
its change after the last compared step ("change"). The numbers:

    loss.<i>  |program - reference| / |reference| of step i's loss
    grad      the worst leaf's |program norm - reference norm| over the
              larger of the reference's norm of that leaf and its median
              leaf's norm (some gradients are all but zero)
    change    the same over the change, leaving out the leaves whose
              reference gradient is under a thousandth of the median leaf's
              (they move by round-off alone under Adam)

A cell's limits (workloads/<cell>.json) are by number: a number without a
limit there is not compared (its readings and the reason are in PERF.md).
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, List

SMALL_GRAD = 1e-3  # a leaf whose reference gradient is under this x the median's


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    leaves = list(leaves)
    mid = median(ref[k] for k in leaves)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], mid, 1e-30) for k in leaves]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    out = {}
    for i, (lp, lr) in enumerate(zip(prog["loss"], ref["loss"]), 1):
        out[f"loss.{i}"] = abs(lp - lr) / max(abs(lr), 1e-30)
    out["grad"] = worst_leaf(prog["grad"], ref["grad"], ref["grad"])
    mid = median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= SMALL_GRAD * mid]
    out["change"] = worst_leaf(prog["change"], ref["change"], moved)
    return out


def within(found: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(found[k]) and found[k] <= limit for k, limit in limits.items())


def lines(found: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    """The numbers not compared first, then each compared number beside its limit."""
    rest = [k for k in found if k not in limits]
    head = ["port_bench: not compared " + ", ".join(f"{k} {found[k]!r}" for k in rest)] if rest else []
    return head + [f"check {k} {found[k]!r} limit {limit!r}" for k, limit in limits.items()]
