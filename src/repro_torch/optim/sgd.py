"""SGD (+momentum) in PyTorch — counterpart of ``repro/optim/sgd.py``: the
FedAvg / Local SGD baseline, identity preconditioner.

Theta is the state: ``{"m": momentum tree}``, or ``{"m": None}`` without
momentum — a Theta with no leaves, which the round engine carries like
any other (its drift is 0).  Trees may carry ``lead`` leading batch dims
(the cohort-stacked client axis); every operation is elementwise.
"""
from __future__ import annotations

import torch

from repro_torch.optim.api import LocalOptimizer
from repro_torch.utils.tree import tree_map


def make(momentum: float = 0.0, weight_decay: float = 0.0) -> LocalOptimizer:
    def init(params, lead: int = 0):
        del lead  # elementwise: the client axis needs no special case
        if momentum:
            return {"m": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)}
        return {"m": None}

    def update(grads, state, params, step: int, lead: int = 0,
               extras=None):
        del step, lead, extras
        gf = tree_map(lambda g: g.to(torch.float32), grads)
        if weight_decay:
            gf = tree_map(lambda g, p: g + weight_decay * p.to(torch.float32),
                          gf, params)
        if momentum:
            m = tree_map(lambda mm, g: momentum * mm + g, state["m"], gf)
            return m, {"m": m}
        return gf, state

    def get_precond(state):
        return state

    def set_precond(state, theta):
        # a per-client theta broadcasts over the state's leading client axis
        if theta["m"] is None or state["m"] is None:
            return theta
        return {"m": tree_map(lambda mm, th: th.to(mm.dtype).expand(mm.shape),
                              state["m"], theta["m"])}

    return LocalOptimizer("sgd", init, update, get_precond, set_precond)
