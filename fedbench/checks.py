"""The numbers that decide ``correct``: the program's readings of its first
rounds against the reference's.

* ``loss.rN``, ``drift.rN``: the round's loss and preconditioner drift,
  |program - reference| / |reference|.
* ``grad.r1``: g_G after round 1 (the gradient as the server's update takes
  it, -mean Delta / (K lr)); ``theta.r1``: the global Theta after round 1;
  ``change.rN``: the parameters' change after the last checked round.
  Each by the worst leaf: the gap between the program's norm of the leaf
  and the reference's, over the larger of the reference's norm of that leaf
  and of the median leaf.  Leaves whose reference g_G is under a thousandth
  of the median leaf's (a gradient that is nought but for rounding) are
  left out of ``grad`` and ``change``.
"""
from __future__ import annotations

import math
import statistics

ZERO_GRAD = 1e-3


def _rel(a, b):
    return abs(a - b) / abs(b) if b else abs(a - b)


def worst_leaf(prog: dict, ref: dict, skip=()) -> float:
    """The worst leaf's gap; infinite where the program lacks a leaf of
    the reference's or has one more."""
    if set(prog) != set(ref):
        return math.inf
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def values(prog: dict, ref: dict) -> dict:
    """Every comparable number of the two readings."""
    out = {}
    for name in ("loss", "drift"):
        for r, (a, b) in enumerate(zip(prog[name], ref[name]), start=1):
            out[f"{name}.r{r}"] = _rel(a, b)
    med = statistics.median(ref["grad"].values())
    skip = {k for k, v in ref["grad"].items() if v < ZERO_GRAD * med}
    out["grad.r1"] = worst_leaf(prog["grad"], ref["grad"], skip)
    out["theta.r1"] = worst_leaf(prog["theta"], ref["theta"])
    out[f"change.r{len(ref['loss'])}"] = worst_leaf(
        prog["change"], ref["change"], skip)
    return out


def judge(vals: dict, limits: dict):
    """(correct, checks): every limited number within its limit, each as
    {"value", "limit"}; a number that is not finite fails."""
    checks = {name: {"value": vals[name], "limit": lim}
              for name, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
