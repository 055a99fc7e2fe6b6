"""Client-side local training: K preconditioned steps with the optional
FedPAC correction (Eq. 9) — counterpart of ``repro/core/client.py``.

The reference vmaps one client's ``lax.scan`` over the cohort.  Here the
whole cohort steps together: parameters and optimizer state carry a
leading (S,) client axis, each step's gradients come from the cohort
executor (``torch.func.vmap`` of ``grad`` over the clients), and the
optimizer then updates the stacked leaves at once, the client axis folded
into its kernels' batch axis.  The K-step scan is a Python loop; SOAP's
refresh gate is a plain ``if`` on the shared step index.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.optim.api import LocalOptimizer
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class LocalRunConfig:
    lr: float
    local_steps: int           # K
    align: bool = True         # warm-start Theta from the global reference

    def __post_init__(self):
        if self.local_steps < 1:
            raise ValueError(
                f"local_steps must be >= 1, got {self.local_steps}")


def client_round(
    loss_fn: Callable,
    opt: LocalOptimizer,
    run: LocalRunConfig,
    x0,               # server params (per-client shapes)
    theta,            # global preconditioner reference (or None)
    g_global,         # estimated global direction g_G^r (params-like)
    batches,          # tree with leading (S, K, ...) axes
    cohort_exec: Callable,
    beta,             # correction strength (Eq. 9); 0 => no correction
):
    """The cohort's round.  Returns (stacked delta_x, stacked theta_final,
    mean loss over clients and steps)."""
    s = next(iter(batches.values())).shape[0]
    x = tree_map(lambda p: p.expand(s, *p.shape).clone(), x0)
    opt_state = opt.init(x, lead=1)
    if run.align and theta is not None:
        opt_state = opt.set_precond(opt_state, theta)

    def loss_and_grad(params, batch):
        return torch.func.grad_and_value(loss_fn)(params, batch)

    losses = []
    for k in range(run.local_steps):
        batch = {name: b[:, k] for name, b in batches.items()}
        grads, loss = cohort_exec(loss_and_grad, x, batch)
        direction, opt_state = opt.update(grads, opt_state, x, k, lead=1)
        # Eq. 9: x <- x - lr [ (1-beta) P_Theta(g) + beta g_G ]
        x = tree_map(
            lambda d, gg, p: (p.to(torch.float32) - run.lr * (
                (1.0 - beta) * d + beta * gg)).to(p.dtype),
            direction, g_global, x)
        losses.append(loss)
    delta = tree_map(lambda a, b: a.to(torch.float32) - b.to(torch.float32),
                     x, x0)
    return delta, opt.get_precond(opt_state), torch.stack(losses).mean()
