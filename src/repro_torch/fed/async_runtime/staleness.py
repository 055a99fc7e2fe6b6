"""Staleness-decay weight functions for buffered-asynchronous aggregation
(counterpart of ``repro/fed/async_runtime/staleness.py``, copied).

A client result that trained from server version v and arrives at version
v' has staleness s = v' - v (>= 0).  Its delta and uploaded Theta are scaled
by w(s) in (0, 1] before aggregation:

  none   w(s) = 1                      (naive async — FedBuff without decay)
  poly   w(s) = 1 / (1 + s)^alpha      (FedBuff / FedAsync polynomial decay)
  hinge  w(s) = 1 if s <= t else 1/(1 + s - t)   (grace window of t versions)
"""
from __future__ import annotations

from typing import Callable


def make_staleness_weight(mode: str = "poly", alpha: float = 0.5,
                          hinge_threshold: int = 2) -> Callable[[float], float]:
    if mode in ("none", "const"):
        return lambda s: 1.0
    if mode == "poly":
        return lambda s: float((1.0 + s) ** -alpha)
    if mode == "hinge":
        t = hinge_threshold
        return lambda s: 1.0 if s <= t else float(1.0 / (1.0 + s - t))
    raise ValueError(f"unknown staleness mode {mode!r} "
                     "(want 'none'|'poly'|'hinge')")
