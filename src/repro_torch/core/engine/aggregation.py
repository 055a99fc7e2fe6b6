"""The server-side aggregation core (Alg. 2 lines 14-17) — counterpart of
``repro/core/engine/aggregation.py``:

  params  x' = x + server_lr * (1/B) sum_i w_i Delta_i
  g_G     g_B = -(sum_i w_i Delta_i / sum_i w_i) / (K eta),
          g' = (1 - rho) g + rho g_B,            rho = mean_i w_i
  Theta   Theta_B = sum_i w_i Theta_i / sum_i w_i,
          Theta' = (1 - rho) Theta + rho Theta_B   (only when cfg.align)

rho is 1 for a synchronous round.  ``precond_mixing_weights`` is FedPM's
curvature-weighted mixing hook.  The streamed (pipeline) forms are not
ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.drift import drift_metric
from repro_torch.core.server import ServerState
from repro_torch.utils.tree import (
    client_weighted_sum, tree_leaves, tree_map, tree_norm_sq,
)


@dataclasses.dataclass(frozen=True)
class AggregationConfig:
    """Static knobs of one server update."""
    lr: float                  # client learning rate eta
    local_steps: int           # K
    server_lr: float = 1.0
    align: bool = True         # update the global Theta reference?


def precond_mixing_weights(deltas, thetas, eps: float = 1e-8):
    """FedPM-style curvature-weighted mixing weights for the delta mean.

    Preconditioned mixing of local parameters (Ishii et al., 2025): each
    client's update is trusted inversely to the mass of its local curvature
    estimate — clients in sharp regions (large mean |Theta_i|) move the
    server less.  Returns (S,) weights normalized to mean 1, so the uniform
    mean is recovered when every client sees the same curvature.
    """
    del deltas
    leaves = tree_leaves(thetas)
    if not leaves:
        raise ValueError(
            "preconditioned mixing needs per-client Theta uploads — use a "
            "second-order local optimizer (sophia/muon/soap/adamw)")
    total, count = 0.0, 0
    for t in leaves:
        tf = torch.abs(t.to(torch.float32)).reshape(t.shape[0], -1)
        total = total + torch.sum(tf, dim=1)
        count += tf.shape[1]
    curv = total / count                    # (S,) mean |Theta_i|
    w = 1.0 / (eps + curv)
    return w / (torch.mean(w) + eps)


def _finish_update_stats(params, theta, g_global, delta_wsum, b, rho, denom,
                         cfg: AggregationConfig, theta_stats):
    """The Alg. 2 tail from reduced cohort statistics: ``b`` the cohort
    size, ``rho``/``denom`` the freshness mean and weight sum."""
    step = tree_map(lambda x: x / b, delta_wsum)
    new_params = tree_map(
        lambda p, d: (p.to(torch.float32)
                      + cfg.server_lr * d).to(p.dtype), params, step)
    # g_G estimate is w-normalized (Alg. 2 line 14)
    g_batch = tree_map(
        lambda x: -(x / denom) / (cfg.local_steps * cfg.lr), delta_wsum)
    new_g = tree_map(lambda old, gb: (1.0 - rho) * old + rho * gb,
                     g_global, g_batch)

    if theta_stats is None:
        zero = torch.zeros((), dtype=torch.float32, device=rho.device)
        return new_params, theta, new_g, {"drift": zero, "norm_drift": zero,
                                          "freshness": rho}
    drift, theta_wsum = theta_stats
    theta_batch = tree_map(lambda x: x / denom, theta_wsum)
    norm_drift = drift / (tree_norm_sq(theta_batch) + 1e-12)
    new_theta = theta
    if cfg.align:
        # Theta is a reference geometry, not a step: freshness-mixed
        old = theta if theta is not None else tree_map(torch.zeros_like,
                                                       theta_batch)
        new_theta = tree_map(
            lambda o, tb: ((1.0 - rho) * o.to(torch.float32)
                           + rho * tb).to(o.dtype), old, theta_batch)
    metrics = {"drift": drift, "norm_drift": norm_drift, "freshness": rho}
    return new_params, new_theta, new_g, metrics


def _finish_update(params, theta, g_global, delta_wsum, w,
                   cfg: AggregationConfig, theta_stats):
    b = w.shape[0]
    rho = torch.mean(w)                     # cohort freshness in (0, 1]
    denom = torch.sum(w) + 1e-12
    return _finish_update_stats(params, theta, g_global, delta_wsum, b, rho,
                                denom, cfg, theta_stats)


def aggregate(params, theta, g_global, deltas, thetas, weights,
              cfg: AggregationConfig):
    """One server update from a stacked cohort (thetas None for
    first-order cohorts).  Returns (new_params, new_theta, new_g, metrics).
    """
    w = weights.to(torch.float32)
    delta_wsum = client_weighted_sum(deltas, w)
    theta_stats = (None if thetas is None else
                   (drift_metric(thetas, w.device),
                    client_weighted_sum(thetas, w)))
    return _finish_update(params, theta, g_global, delta_wsum, w, cfg,
                          theta_stats)


def aggregate_wire(params, theta, g_global, dmsgs, weights,
                   cfg: AggregationConfig, transport, *, tmsgs=None,
                   thetas=None, need_thetas: bool = False):
    """The fused wire-native server update: encoded uploads accumulate
    straight into the weighted sums (``Codec.accumulate``).

    Theta uploads arrive as stacked wire messages (``tmsgs``, aligned
    algorithms) or as an already-dense stacked tree (``thetas``); neither
    for first-order cohorts.  Lossless theta codecs decode (free for
    dense) and take the exact classic drift path; lossy codecs (qblock)
    compute drift wire-natively from per-client squared norms
    (``Codec.sq_norms``) and the accumulated mean, never decoding the
    stack.  ``need_thetas=True`` decodes a lossy stack as well, for the
    telemetry's geometry sketch; the training numerics do not change with
    it.  Returns (new_params, new_theta, new_g, metrics, aux) with
    ``aux["step"]`` the weighted delta mean and ``aux["thetas"]`` the
    decoded stack (None on the lossy path without ``need_thetas``).
    """
    if tmsgs is not None and thetas is not None:
        raise ValueError("pass theta uploads as tmsgs (wire) or thetas "
                         "(dense), not both")
    w = weights.to(torch.float32)
    b = w.shape[0]
    delta_wsum = transport.delta.accumulate(dmsgs, w)

    if tmsgs is not None and not transport.theta.lossless:
        # wire-native drift: Def. 1 decomposed as
        # mean_i ||Theta_i||^2 - ||mean_i Theta_i||^2, clamped at 0
        if need_thetas:
            thetas = transport.theta.decode(tmsgs)
        sq = transport.theta.sq_norms(tmsgs)
        usum = transport.theta.accumulate(
            tmsgs, torch.ones((b,), dtype=torch.float32, device=w.device))
        ubar_sq = tree_norm_sq(tree_map(lambda x: x / b, usum))
        drift = torch.clamp(torch.mean(sq) - ubar_sq, min=0.0)
        theta_stats = (drift, transport.theta.accumulate(tmsgs, w))
    else:
        if tmsgs is not None:
            thetas = transport.theta.decode(tmsgs)
        theta_stats = (None if thetas is None else
                       (drift_metric(thetas, w.device),
                        client_weighted_sum(thetas, w)))
    out = _finish_update(params, theta, g_global, delta_wsum, w, cfg,
                         theta_stats)
    step = tree_map(lambda x: x / b, delta_wsum)
    return (*out, {"step": step, "thetas": thetas})


def advance_server(server: ServerState, params, theta, g_global, *,
                   geom=None, aligned: bool) -> ServerState:
    """Next ServerState: round += 1; theta_version stamped only when the
    geometry reference actually refreshed (align=True rounds)."""
    r = server.round + 1
    return ServerState(params, theta, g_global, r,
                       r if aligned else server.theta_version,
                       geom if geom is not None else server.geom)
