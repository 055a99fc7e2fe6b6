"""FedPAC rounds (the paper's Alg. 2) in plain PyTorch float32, the
cohort's clients side by side, from the benchmark's weights and the
batches the round was fed.

A round: each client of the cohort starts from the server's parameters,
aligns its optimizer's preconditioner to the global Theta (FedPAC's
alignment; round 1 has none), and takes K local steps
x <- x - lr [(1 - beta) P(g) + beta g_G] (FedPAC's correction with the
global direction g_G; zero in round 1).  The server then averages the
uploads (the dense float32 wire: an upload is its tensors):

  x'    = x + server_lr mean_i Delta_i
  g_G'  = -(mean_i Delta_i) / (K lr)
  Theta'= mean_i Theta_i
  drift = sum over Theta's leaves of mean_i ||Theta_i - mean_j Theta_j||^2

The round's loss is the mean of the clients' losses over their K steps.
Each step's loss and gradient are taken over the whole batch; a batch is
fed in blocks of rows (``micro`` rows a client) and the blocks' gradients
are summed with weights rows/B, so that the reference fits beside nothing
else on the card.

``fault`` plants a fault in the reference, for the calibration of the
limits: "half_batch" (each step's loss over the first half of its rows),
"drop_client" (the last client's upload left out of the average).
"""
from __future__ import annotations

import numpy as np
import torch

from fedbench.reference.optim import OPTIMIZERS

FAULTS = ("half_batch", "drop_client")


def _value_and_grad(loss_fn, x, batch, micro: int):
    """Each client's mean loss over its rows and its gradient, the rows fed
    in blocks of ``micro`` a client.  ``loss_fn`` gives the (S,) losses of
    the cohort; their sum's gradient is each client's own."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in x.items()}
    rows = next(iter(batch.values())).shape[1]
    total, grads = 0.0, None
    for a in range(0, rows, micro):
        part = {k: v[:, a:a + micro] for k, v in batch.items()}
        n = next(iter(part.values())).shape[1]
        lv = loss_fn(leaves, part) * (n / rows)
        gs = torch.autograd.grad(lv.sum(), list(leaves.values()))
        grads = (list(gs) if grads is None
                 else [acc + g for acc, g in zip(grads, gs)])
        total = total + lv.detach()
    return total, dict(zip(leaves, grads))


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v)) for k, v in tree.items()}


def _stack(cohort, k, device):
    """Step ``k``'s batches of every client, stacked to (S, B, ...)."""
    return {n: torch.as_tensor(np.stack([steps[k][n] for steps in cohort]))
            .to(device) for n in cohort[0][k]}


def run_rounds(loss_fn, params0, rounds, *, algorithm: str, lr: float,
               beta: float, server_lr: float, opt_kwargs: dict, prec,
               device, micro: int, fault=None):
    """Follow ``rounds`` (per round, per cohort client, the K step batches
    as dicts of host arrays) from ``params0`` (a flat dict).  The cohort's
    clients step together, each on a leading axis of its own.  Returns the
    readings the benchmark compares: the loss and drift of every round,
    the per-leaf norms of g_G and Theta after round 1, and of the change
    of the parameters after the last round."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} (want one of {FAULTS})")
    kind, _, opt_name = algorithm.partition("_")
    if kind != "fedpac" or opt_name not in OPTIMIZERS:
        raise ValueError(f"the reference runs fedpac_{{{','.join(OPTIMIZERS)}}}"
                         f", not {algorithm!r}")
    opt = OPTIMIZERS[opt_name](prec, **opt_kwargs)
    params = {k: v.detach().clone() for k, v in params0.items()}
    g_glob = {k: torch.zeros_like(v) for k, v in params.items()}
    theta = None
    out = {"loss": [], "drift": []}
    for r, cohort in enumerate(rounds, start=1):
        s, k_steps = len(cohort), len(cohort[0])
        x = {k: v.expand(s, *v.shape).clone() for k, v in params.items()}
        st = opt.init(x)
        if theta is not None:
            opt.set_theta(st, theta)
        losses = []
        for k in range(k_steps):
            batch = _stack(cohort, k, device)
            if fault == "half_batch":
                half = next(iter(batch.values())).shape[1] // 2
                batch = {n: a[:, :half] for n, a in batch.items()}
            lv, grads = _value_and_grad(loss_fn, x, batch, micro)
            d = opt.direction(grads, st, k)
            x = {n: x[n] - lr * ((1.0 - beta) * d[n] + beta * g_glob[n])
                 for n in x}
            losses.append(lv)
        up = s - 1 if fault == "drop_client" else s
        mean_delta = {n: (x[n][:up] - params[n]).sum(0) / up for n in x}
        thetas = {n: t[:up] for n, t in opt.theta(st).items()}
        del x, st
        params = {n: params[n] + server_lr * mean_delta[n] for n in params}
        g_glob = {n: -mean_delta[n] / (k_steps * lr) for n in params}
        theta = {n: t.mean(0) for n, t in thetas.items()}
        drift = sum(float(torch.sum((t - theta[n]) ** 2)) for n, t in
                    thetas.items()) / up
        out["loss"].append(float(torch.stack(losses).mean()))
        out["drift"].append(drift)
        if r == 1:
            out["grad"] = _norms(g_glob)
            out["theta"] = _norms(theta)
    out["change"] = _norms({n: params[n] - params0[n] for n in params})
    return out
