"""The server-side aggregation core (Alg. 2 lines 14-17) — counterpart of
``repro/core/engine/aggregation.py``:

  params  x' = x + server_lr * (1/B) sum_i w_i Delta_i
  g_G     g_B = -(sum_i w_i Delta_i / sum_i w_i) / (K eta),
          g' = (1 - rho) g + rho g_B,            rho = mean_i w_i
  Theta   Theta_B = sum_i w_i Theta_i / sum_i w_i,
          Theta' = (1 - rho) Theta + rho Theta_B   (only when cfg.align)

rho is 1 for a synchronous round.  The streamed (pipeline) forms are not
ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.drift import drift_metric
from repro_torch.core.server import ServerState
from repro_torch.utils.tree import client_weighted_sum, tree_map, tree_norm_sq


@dataclasses.dataclass(frozen=True)
class AggregationConfig:
    """Static knobs of one server update."""
    lr: float                  # client learning rate eta
    local_steps: int           # K
    server_lr: float = 1.0
    align: bool = True         # update the global Theta reference?


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
                   (drift_metric(thetas), client_weighted_sum(thetas, w)))
    return _finish_update(params, theta, g_global, delta_wsum, w, cfg,
                          theta_stats)


def aggregate_wire(params, theta, g_global, dmsgs, weights,
                   cfg: AggregationConfig, transport, *, tmsgs=None,
                   thetas=None):
    """The fused wire-native server update: encoded uploads accumulate
    straight into the weighted sums (``Codec.accumulate``).

    Theta uploads arrive as stacked wire messages (``tmsgs``, aligned
    algorithms) or as an already-dense stacked tree (``thetas``); neither
    for first-order cohorts.  Lossless theta codecs decode (free for
    dense) and take the exact classic drift path.  Returns (new_params,
    new_theta, new_g, metrics, aux) with ``aux["step"]`` the weighted
    delta mean and ``aux["thetas"]`` the decoded stack.
    """
    if tmsgs is not None and thetas is not None:
        raise ValueError("pass theta uploads as tmsgs (wire) or thetas "
                         "(dense), not both")
    w = weights.to(torch.float32)
    b = w.shape[0]
    delta_wsum = transport.delta.accumulate(dmsgs, w)

    if tmsgs is not None:
        if not transport.theta.lossless:
            raise NotImplementedError(
                "lossy theta codecs (wire-native drift) are not ported")
        thetas = transport.theta.decode(tmsgs)
    theta_stats = (None if thetas is None else
                   (drift_metric(thetas), client_weighted_sum(thetas, w)))
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
