"""The comparison that decides ``correct`` for a training cell: what the
program's first steps produced against what the reference works out again
from the same weights and batches.

The numbers, each compared where the cell's file in ``checks/`` gives it a
limit:

* ``loss_gap``: the largest gap of a step's loss, over the reference's;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer gets it (clipped), the program's read back from
  its first moment;
* ``grad_err``: the worst leaf's norm of the difference of those two
  first gradients, element by element;
* ``moment_gap``: the worst leaf's gap between the norms of the second
  moment after the checked steps; ``moment_gap_median`` the median leaf's
  (a leaf of a few thousand per-head values, whose second moment's norm a
  few elements make, can read the worst);
* ``change_gap``: the worst leaf's gap between the norms of the change the
  steps made, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (rounding alone moves them under Adam).

A leaf's gap is taken over the larger of the reference's norm of that leaf
and the median leaf's, since some gradients are all but zero.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable

NEGLIGIBLE_GRAD = 1e-3


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              names: Iterable[str]) -> list:
    names = list(names)
    floor = statistics.median(reference[n] for n in names)
    return [abs(program[n] - reference[n]) / max(reference[n], floor)
            for n in names]


def numbers(program: dict, reference: dict) -> Dict[str, float]:
    """The compared numbers, from two readings of the form
    `reference.train.follow` returns; ``program["grad_diffs"]`` holds each
    leaf's distance from the program's first gradient to the reference's."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in
                   zip(program["losses"], reference["losses"], strict=True))
    grads = reference["grad_norms"]
    median = statistics.median(grads.values())
    moved = [n for n in grads if grads[n] >= NEGLIGIBLE_GRAD * median]
    moments = leaf_gaps(program["moment_norms"], reference["moment_norms"],
                        grads)
    return {"loss_gap": loss_gap,
            "grad_gap": max(leaf_gaps(program["grad_norms"], grads, grads)),
            "grad_err": max(program["grad_diffs"][n] / max(grads[n], median)
                            for n in grads),
            "moment_gap": max(moments),
            "moment_gap_median": statistics.median(moments),
            "change_gap": max(leaf_gaps(program["change_norms"],
                                        reference["change_norms"], moved))}


def judge(found: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number beside its limit; ``correct`` when every one is finite
    and within it."""
    checks = {name: {"value": found.get(name, math.nan), "limit": limit}
              for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return {"correct": ok, "checks": checks}
