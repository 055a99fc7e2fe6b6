"""Sophia (Alg. 8/9) in PyTorch — counterpart of ``repro/optim/sophia.py``:
diagonal-Hessian (Hutchinson) preconditioning with element-wise clipping.
Theta = {h}.

The client loop supplies ``extras = {"h_est": tree}`` on the steps that
refresh the curvature (every ``hessian_freq`` steps), where
``h_est = u * (H u)`` is the Hutchinson estimate
(``core.client.hutchinson_estimate``); on the other steps it passes no
estimate and ``h`` is left as it is, which is what the reference's gated
``where`` computes.  The gated EMA ``h' = b2 h + (1-b2) max(est, 0)``
stays outside the kernel, as in the reference; the momentum and the
clipped direction ``clip(m' / max(h', eps), ±rho)`` of every leaf come
from one grouped ``sophia_update`` launch a step, and weight decay is
added after it.  Trees may carry ``lead`` leading batch dims (the
cohort-stacked client axis); every operation is elementwise, so they need
no care.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sophia_update.kernel import sophia_update_group
from repro_torch.optim.api import LocalOptimizer
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def make(b1: float = 0.9, b2: float = 0.99, eps: float = 1e-12,
         rho: float = 0.05, weight_decay: float = 0.0) -> LocalOptimizer:

    def init(params, lead: int = 0):
        del lead  # elementwise state: the client axis needs no care

        def zeros(p):
            return torch.zeros(p.shape, device=p.device, dtype=torch.float32)

        return {"m": tree_map(zeros, params), "h": tree_map(zeros, params)}

    def update(grads, state, params, step: int, lead: int = 0,
               extras=None):
        del step, lead
        h = state["h"]
        if extras is not None and extras.get("h_est") is not None:
            h = tree_map(
                lambda hh, est: b2 * hh + (1 - b2) * torch.clamp(
                    est.to(torch.float32), min=0.0), h, extras["h_est"])
        ds, ms = sophia_update_group(
            tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(h),
            b1=b1, rho=rho, eps=eps)
        direction = tree_unflatten(grads, ds)
        m = tree_unflatten(grads, ms)
        if weight_decay:
            direction = tree_map(
                lambda d, p: d + weight_decay * p.to(torch.float32),
                direction, params)
        return direction, {"m": m, "h": h}

    def get_precond(state):
        return {"h": state["h"]}

    def set_precond(state, theta):
        # a per-client theta broadcasts over the state's leading client axis
        h = tree_map(lambda hh, th: th.to(torch.float32).expand(
            hh.shape).contiguous(), state["h"], theta["h"])
        return dict(state, h=h)

    return LocalOptimizer("sophia", init, update, get_precond, set_precond,
                          needs_hessian=True)
