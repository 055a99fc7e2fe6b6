"""AdamW in PyTorch — counterpart of ``repro/optim/adamw.py``: the paper's
``Local AdamW`` baseline.

  m' = b1 m + (1-b1) g,  v' = b2 v + (1-b2) g^2,
  d  = (m'/bc1) / (sqrt(v'/bc2) + eps) + weight_decay * p

with bc = 1 - b**(step+1): the moment pass and the normalised step are
exactly what the ``adam_moments`` kernel computes, so every leaf goes
through it; weight decay is added afterwards, as the reference does.
Theta = {m, v}.  Trees may carry ``lead`` leading batch dims (the
cohort-stacked client axis); every operation is elementwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.soap_rotate.kernel import adam_moments
from repro_torch.optim.api import LocalOptimizer
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_get, tree_map, tree_map_with_path,
)


def make(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> LocalOptimizer:
    def init(params, lead: int = 0):
        del lead
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step: int, lead: int = 0,
               extras=None):
        del lead, extras
        out = {}
        for path, p in tree_flatten_with_path(params):
            d, m, v = adam_moments(
                tree_get(grads, path), tree_get(state["m"], path),
                tree_get(state["v"], path), b1=b1, b2=b2, eps=eps, step=step)
            if weight_decay:
                d = d + weight_decay * p.to(torch.float32)
            out[path] = (d, m, v)

        def pick(i):
            return tree_map_with_path(lambda path, _: out[path][i], params)

        return pick(0), {"m": pick(1), "v": pick(2)}

    def get_precond(state):
        return {"m": state["m"], "v": state["v"]}

    def set_precond(state, theta):
        # a per-client theta broadcasts over the state's leading client axis
        def leaf(s, th):
            return th.to(s.dtype).expand(s.shape)
        return {"m": tree_map(leaf, state["m"], theta["m"]),
                "v": tree_map(leaf, state["v"], theta["v"])}

    return LocalOptimizer("adamw", init, update, get_precond, set_precond,
                          precond_multiplier=2.0)
