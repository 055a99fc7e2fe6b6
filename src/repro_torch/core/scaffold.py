"""SCAFFOLD (Karimireddy et al. 2020) — the first-order control-variate
baseline, through the per-client state protocol (counterpart of
``repro/core/scaffold.py``).

Per-client control variate c_i and server control c; local step
  x <- x - lr (g - c_i + c)
Option-II update  c_i' = c_i - c + (x0 - xK)/(K lr);
server: c <- c + (S/N) mean_i (c_i' - c_i).

The algorithm is an ``AlgorithmSpec`` whose ``local_update`` runs the
control-variate steps and whose ``ClientStateSpec`` declares (c, {c_i})
as per-client state; the engine's one round path gathers the cohort's
variates, aggregates the deltas, and scatters the refreshed variates
back.  The reference writes the local update for one client under
``vmap``; here it steps the whole stacked cohort at once, as
``core.client.client_round`` does, with gradients from the cohort
executor.  The stacked variates are written in place, as the
error-feedback residuals are.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.algorithms import (
    AlgorithmSpec, ClientStateSpec, register,
)
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ScaffoldState:
    c_global: Any          # tree like params (f32)
    c_clients: Any         # tree with a leading (N,) axis (f32)

    @staticmethod
    def init(params, n_clients: int):
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        stacked = tree_map(
            lambda p: torch.zeros((n_clients, *p.shape), dtype=torch.float32,
                                  device=p.device), params)
        return ScaffoldState(zeros, stacked)


def _put(c, idx, rows):
    c[idx] = rows.to(c.dtype)
    return c


def _client_view(state: ScaffoldState, cohort):
    """The cohort's read: the global control and its own variates."""
    return state.c_global, tree_map(lambda c: c[cohort], state.c_clients)


def _client_export(state: ScaffoldState, cid):
    """Spill hook: only the client's own variate is private state;
    ``c_global`` is server-owned and stays resident."""
    return tree_map(lambda c: c[cid], state.c_clients)


def _client_import(state: ScaffoldState, cid, row):
    tree_map(lambda c, r: _put(c, cid, r), state.c_clients, row)
    return state


def _client_import_many(state: ScaffoldState, cids, rows):
    """Batched graft: one scatter into c_clients for a whole cohort."""
    ids = torch.as_tensor(cids, dtype=torch.long)
    tree_map(lambda c, r: _put(c, ids, r), state.c_clients, rows)
    return state


def _server_update(state: ScaffoldState, cohort, outs, n_clients: int):
    """Option-II server bookkeeping: scatter refreshed variates, move c."""
    c_i_new, c_diffs = outs
    s = cohort.shape[0]
    new_c_global = tree_map(
        lambda c, cd: c + (s / n_clients) * torch.mean(cd, dim=0),
        state.c_global, c_diffs)
    tree_map(lambda c, u: _put(c, cohort, u), state.c_clients, c_i_new)
    return ScaffoldState(new_c_global, state.c_clients)


def make_scaffold_local_update(spec, loss_fn, opt, run):
    """K control-variate SGD steps of the stacked cohort; returns
    (delta, None, (c_i', c_i' - c_i), loss)."""
    del spec, opt
    lr, local_steps = run.lr, run.local_steps

    def local_fn(params, theta, g_global, *, beta, view, batches,
                 cohort_exec, seed=0, probe_fn=None):
        del theta, g_global, beta, seed, probe_fn  # first-order, uncorrected
        c_global, c_i = view
        s = next(iter(batches.values())).shape[0]
        x = tree_map(lambda p: p.expand(s, *p.shape).clone(), params)

        def upd(p, gg, ci, c):
            d = gg.to(torch.float32) - ci + c
            return (p.to(torch.float32) - lr * d).to(p.dtype)

        grad_fn = torch.func.grad(loss_fn)
        losses = []
        for k in range(local_steps):
            batch = {name: b[:, k] for name, b in batches.items()}
            g = cohort_exec(grad_fn, x, batch)
            x = tree_map(upd, x, g, c_i, c_global)
            # the reference's scan reports the loss after each step
            losses.append(cohort_exec(loss_fn, x, batch))
        delta = tree_map(lambda a, b: a.to(torch.float32)
                         - b.to(torch.float32), x, params)
        # Option II control-variate refresh
        c_i_new = tree_map(lambda ci, c, d: ci - c - d / (local_steps * lr),
                           c_i, c_global, delta)
        c_diff = tree_map(lambda a, b: a - b, c_i_new, c_i)
        return delta, None, (c_i_new, c_diff), torch.stack(losses).mean()

    return local_fn


SCAFFOLD_SPEC = register(AlgorithmSpec(
    name="scaffold", optimizer="sgd",
    local_update=make_scaffold_local_update,
    client_state=ClientStateSpec(init=ScaffoldState.init,
                                 client_view=_client_view,
                                 server_update=_server_update,
                                 client_export=_client_export,
                                 client_import=_client_import,
                                 client_import_many=_client_import_many),
    # the reference's historical default: its legacy parser's "scaffold"
    # token bypassed the SGD table lr (0.1) and fell back to 1e-2
    default_lr=1e-2,
    description="control variates (Karimireddy et al. 2020); lock-step "
                "per-client state => synchronous runtime only"))
