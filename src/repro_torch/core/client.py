"""Client-side local training: K preconditioned steps with the optional
FedPAC correction (Eq. 9) — counterpart of ``repro/core/client.py``.

The reference vmaps one client's ``lax.scan`` over the cohort.  Here the
whole cohort steps together: parameters and optimizer state carry a
leading (S,) client axis, each step's gradients come from the cohort
executor (``torch.func.vmap`` of ``grad`` over the clients), and the
optimizer then updates the stacked leaves at once, the client axis folded
into its kernels' batch axis.  The K-step scan is a Python loop; SOAP's
refresh gate and Sophia's curvature gate (``k % hessian_freq == 0``) are
plain ``if``s on the shared step index.

Sophia's curvature comes from ``hutchinson_estimate`` under the same
executor.  Its Rademacher probes come from ``torch.Generator``s on the
run's device (``probe_generators``): on the legacy path one generator,
seeded from the round's integer ``seed``, draws for the stacked cohort;
in population mode ``seed`` holds one seed per client (its population
seed and the round's salt) and each client draws from a generator of its
own, so its probes do not depend on its chunk or its position in the
cohort.  They cannot be the reference's ``jax.random`` bits, so
``probe_fn`` lets a caller inject probes (the parity tests rebuild the
reference's own).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.optim.api import LocalOptimizer
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_map, tree_map_with_path,
)


@dataclasses.dataclass(frozen=True)
class LocalRunConfig:
    lr: float
    local_steps: int           # K
    beta: float = 0.0          # correction strength (Eq. 9); 0 => none
    hessian_freq: int = 10     # Sophia's f_h
    align: bool = True         # warm-start Theta from the global reference

    def __post_init__(self):
        if self.local_steps < 1:
            raise ValueError(
                f"local_steps must be >= 1, got {self.local_steps}")
        if self.hessian_freq < 1:
            raise ValueError(
                f"hessian_freq must be >= 1 (step k refreshes the Hutchinson "
                f"estimate when k % hessian_freq == 0), got "
                f"{self.hessian_freq}")


def hutchinson_estimate(loss_fn, params, batch, probes):
    """u * (H u) for one client, H the Hessian of ``loss_fn`` at
    ``params``: a Pearlmutter HVP as forward-over-reverse
    (``torch.func.jvp`` of ``torch.func.grad``, the reference's
    ``jax.jvp`` of ``jax.grad``).  ``probes`` is a params-like tree."""
    def grad_fn(p):
        return torch.func.grad(loss_fn)(p, batch)

    u = tree_map(lambda uu, p: uu.to(p.dtype), probes, params)
    _, hvp = torch.func.jvp(grad_fn, (params,), (u,))
    return tree_map(lambda uu, hh: uu.to(torch.float32)
                    * hh.to(torch.float32), probes, hvp)


def rademacher_like(tree, gen: torch.Generator):
    """±1 f32 probes shaped like ``tree``, drawn leaf by leaf in reference
    leaf order from ``gen``."""
    draws = {
        path: torch.randint(0, 2, leaf.shape, generator=gen,
                            device=leaf.device).to(torch.float32) * 2 - 1
        for path, leaf in tree_flatten_with_path(tree)}
    return tree_map_with_path(lambda path, _: draws[path], tree)


def probe_generators(seed, clients: int, device):
    """Sophia's probe source: one generator for the stacked cohort from an
    integer ``seed`` (the legacy round's draw), or one generator per
    client from a sequence of ``clients`` per-client seeds."""
    if isinstance(seed, (int, np.integer)):
        return torch.Generator(device=device).manual_seed(int(seed))
    seeds = [int(v) for v in np.asarray(seed).ravel()]
    if len(seeds) != clients:
        raise ValueError(f"{len(seeds)} per-client probe seeds for a cohort "
                         f"of {clients}")
    return [torch.Generator(device=device).manual_seed(v) for v in seeds]


def draw_probes(x, gens):
    """Stacked ±1 probes shaped like the stacked ``x``: from one generator
    over the whole stack, or row by row from one generator a client."""
    if isinstance(gens, torch.Generator):
        return rademacher_like(x, gens)
    row = tree_map(lambda leaf: leaf[0], x)
    rows = [rademacher_like(row, g) for g in gens]
    return tree_map(lambda *r: torch.stack(r), *rows)


def client_round(
    loss_fn: Callable,
    opt: LocalOptimizer,
    run: LocalRunConfig,
    x0,               # server params (per-client shapes)
    theta,            # global preconditioner reference (or None)
    g_global,         # estimated global direction g_G^r (params-like)
    batches,          # tree with leading (S, K, ...) axes
    cohort_exec: Callable,
    beta=None,        # runtime override (drift-adaptive beta);
    #                   None -> run.beta
    *,
    seed=0,           # the round's draw, or (S,) per-client seeds: seeds
    #                   the Hutchinson probes (``probe_generators``)
    probe_fn: Optional[Callable] = None,
):
    """The cohort's round.  Returns (stacked delta_x, stacked theta_final,
    mean loss over clients and steps).

    ``probe_fn(k) -> stacked probe tree`` (params-like, leading (S,))
    replaces the generator's probes at step ``k``; it is called only on
    the steps that refresh the curvature of an optimizer that
    ``needs_hessian``.
    """
    beta = run.beta if beta is None else beta
    s = next(iter(batches.values())).shape[0]
    x = tree_map(lambda p: p.expand(s, *p.shape).clone(), x0)
    opt_state = opt.init(x, lead=1)
    if run.align and theta is not None:
        opt_state = opt.set_precond(opt_state, theta)
    gens = None
    if opt.needs_hessian and probe_fn is None:
        gens = probe_generators(seed, s, next(iter(batches.values())).device)

    def loss_and_grad(params, batch):
        return torch.func.grad_and_value(loss_fn)(params, batch)

    def hvp(params, batch, probes):
        return hutchinson_estimate(loss_fn, params, batch, probes)

    losses = []
    for k in range(run.local_steps):
        batch = {name: b[:, k] for name, b in batches.items()}
        grads, loss = cohort_exec(loss_and_grad, x, batch)
        extras = None
        if opt.needs_hessian and k % run.hessian_freq == 0:
            u = probe_fn(k) if probe_fn is not None else draw_probes(x, gens)
            extras = {"h_est": cohort_exec(hvp, x, batch, u)}
        direction, opt_state = opt.update(grads, opt_state, x, k, lead=1,
                                          extras=extras)
        # Eq. 9: x <- x - lr [ (1-beta) P_Theta(g) + beta g_G ]
        x = tree_map(
            lambda d, gg, p: (p.to(torch.float32) - run.lr * (
                (1.0 - beta) * d + beta * gg)).to(p.dtype),
            direction, g_global, x)
        losses.append(loss)
    delta = tree_map(lambda a, b: a.to(torch.float32) - b.to(torch.float32),
                     x, x0)
    return delta, opt.get_precond(opt_state), torch.stack(losses).mean()
