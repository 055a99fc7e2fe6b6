"""The server-side aggregation core (Alg. 2 lines 14-17) — counterpart of
``repro/core/engine/aggregation.py``:

  params  x' = x + server_lr * (1/B) sum_i w_i Delta_i
  g_G     g_B = -(sum_i w_i Delta_i / sum_i w_i) / (K eta),
          g' = (1 - rho) g + rho g_B,            rho = mean_i w_i
  Theta   Theta_B = sum_i w_i Theta_i / sum_i w_i,
          Theta' = (1 - rho) Theta + rho Theta_B   (only when cfg.align)

rho is 1 for a synchronous round.  ``precond_mixing_weights`` is FedPM's
curvature-weighted mixing hook.  ``stream_chunk``/``finish_stream`` are
the streamed forms the chunk pipeline (``fed.pipeline``) folds a cohort
with, chunk by chunk.
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


def weighted_client_mean(tree, weights=None):
    """Mean over the leading client axis; with weights (FedBuff) the
    unnormalized (1/S) sum_i w_i x_i, so a stale buffer takes a smaller
    server step.  weights=None is the uniform mean."""
    if weights is None:
        return tree_map(lambda x: torch.mean(x, dim=0), tree)
    b = weights.shape[0]
    return tree_map(lambda x: x / b, client_weighted_sum(tree, weights))


def normalized_client_mean(tree, weights):
    """sum_i w_i x_i / sum_i w_i over the leading client axis."""
    w = weights.to(torch.float32)
    denom = torch.sum(w) + 1e-12
    return tree_map(lambda x: x / denom, client_weighted_sum(tree, w))


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


# ------------------------------------------------- streamed aggregation
#
# The chunk-streaming pipeline never stacks the whole cohort: each chunk's
# wire uploads fold into running f32 weighted sums (``stream_chunk``,
# backed by the carry-accepting ``Codec.accumulate``) and one
# ``finish_stream`` applies the Alg. 2 tail from the reduced statistics.
# A single-chunk stream with ``exact=True`` runs the very expressions of
# ``aggregate_wire`` (carry=None accumulates, the same drift), so it is
# bitwise equal to the monolithic flush; multi-chunk streams compute the
# drift by the decomposition mean_i ||Theta_i||^2 - ||mean_i Theta_i||^2
# (clamped at 0), the formula ``aggregate_wire`` uses for lossy codecs.

_CARRY_KEYS = ("delta_wsum", "w_sum", "theta_wsum", "theta_usum",
               "theta_sq_sum", "theta_drift")


def _flat_sq(thetas, b, device):
    """(B,) per-client squared norm of a dense stacked tree (zeros for a
    tree with no leaves)."""
    total = torch.zeros((b,), dtype=torch.float32, device=device)
    for x in tree_leaves(thetas):
        total = total + torch.sum(
            x.to(torch.float32).reshape(x.shape[0], -1) ** 2, dim=-1)
    return total


def stream_chunk(carry, dmsgs, weights, transport, *, tmsgs=None,
                 thetas=None, exact: bool = False):
    """Fold one chunk's uploads into the running aggregation carry.

    ``carry`` is None for the first chunk, else the dict this function
    returned for the previous one.  ``tmsgs``/``thetas`` mirror
    ``aggregate_wire``: Theta uploads as stacked wire messages or as an
    already-dense stacked tree.  ``exact=True`` is the single-chunk mode
    (invalid with a carry): the drift comes out as ``aggregate_wire``
    computes it, so ``finish_stream`` reproduces it bitwise.  The running
    scalar sums are updated in place from the second chunk on."""
    if tmsgs is not None and thetas is not None:
        raise ValueError("pass theta uploads as tmsgs (wire) or thetas "
                         "(dense), not both")
    if exact and carry is not None:
        raise ValueError("exact streaming is single-chunk only "
                         "(carry must be None)")
    w = weights.to(torch.float32)
    b = w.shape[0]
    prev = carry if carry is not None else dict.fromkeys(_CARRY_KEYS)
    out = dict(prev)
    out["delta_wsum"] = transport.delta.accumulate(
        dmsgs, w, carry=prev["delta_wsum"])
    out["w_sum"] = _acc(prev["w_sum"], torch.sum(w))
    out["theta_drift"] = None
    ones = torch.ones((b,), dtype=torch.float32, device=w.device)

    if tmsgs is not None and not (exact and transport.theta.lossless):
        sq = transport.theta.sq_norms(tmsgs)
        usum = transport.theta.accumulate(tmsgs, ones,
                                          carry=prev["theta_usum"])
        if exact:       # aggregate_wire's lossy drift, verbatim
            ubar_sq = tree_norm_sq(tree_map(lambda x: x / b, usum))
            out["theta_drift"] = torch.clamp(torch.mean(sq) - ubar_sq,
                                             min=0.0)
        else:
            out["theta_sq_sum"] = _acc(prev["theta_sq_sum"], torch.sum(sq))
            out["theta_usum"] = usum
        out["theta_wsum"] = transport.theta.accumulate(
            tmsgs, w, carry=prev["theta_wsum"])
    elif tmsgs is not None or thetas is not None:
        if tmsgs is not None:
            thetas = transport.theta.decode(tmsgs)
        if exact:
            out["theta_drift"] = drift_metric(thetas, w.device)
            out["theta_wsum"] = client_weighted_sum(thetas, w)
        else:
            out["theta_sq_sum"] = _acc(prev["theta_sq_sum"],
                                       torch.sum(_flat_sq(thetas, b, w.device)))
            out["theta_usum"] = _acc_tree(prev["theta_usum"],
                                          client_weighted_sum(thetas, ones))
            out["theta_wsum"] = _acc_tree(prev["theta_wsum"],
                                          client_weighted_sum(thetas, w))
    return out


def _acc(prev, x):
    return x if prev is None else prev.add_(x)


def _acc_tree(prev, tree):
    if prev is None:
        return tree
    return tree_map(lambda a, c: a.add_(c), prev, tree)


def finish_stream(params, theta, g_global, carry, cohort_size: int,
                  cfg: AggregationConfig):
    """Apply the Alg. 2 tail to a fully folded stream carry.
    ``cohort_size`` is the total b (the chunks' sizes sum to it).  Returns
    (new_params, new_theta, new_g, metrics, aux) with ``aux["step"]`` the
    weighted delta mean."""
    b = int(cohort_size)
    rho = carry["w_sum"] / b
    denom = carry["w_sum"] + 1e-12
    if carry["theta_wsum"] is None:
        theta_stats = None
    elif carry["theta_drift"] is not None:       # exact single-chunk path
        theta_stats = (carry["theta_drift"], carry["theta_wsum"])
    else:
        ubar_sq = tree_norm_sq(tree_map(lambda x: x / b,
                                        carry["theta_usum"]))
        drift = torch.clamp(carry["theta_sq_sum"] / b - ubar_sq, min=0.0)
        theta_stats = (drift, carry["theta_wsum"])
    out = _finish_update_stats(params, theta, g_global, carry["delta_wsum"],
                               b, rho, denom, cfg, theta_stats)
    step = tree_map(lambda x: x / b, carry["delta_wsum"])
    return (*out, {"step": step})


def advance_server(server: ServerState, params, theta, g_global, *,
                   geom=None, aligned: bool) -> ServerState:
    """Next ServerState: round += 1; theta_version stamped only when the
    geometry reference actually refreshed (align=True rounds)."""
    r = server.round + 1
    return ServerState(params, theta, g_global, r,
                       r if aligned else server.theta_version,
                       geom if geom is not None else server.geom)


def aggregate_round(server: ServerState, deltas, thetas, *, lr: float,
                    local_steps: int, server_lr: float = 1.0,
                    weights=None) -> ServerState:
    """Core-level weighted entry point: one ``aggregate`` -> ServerState.
    weights=None is the synchronous uniform mean (ones); thetas=None
    leaves the geometry reference and its version untouched."""
    cfg = AggregationConfig(lr=lr, local_steps=local_steps,
                            server_lr=server_lr, align=thetas is not None)
    if weights is None:
        lead = tree_leaves(deltas)[0]
        weights = torch.ones((lead.shape[0],), dtype=torch.float32,
                             device=lead.device)
    new_params, new_theta, new_g, _ = aggregate(
        server.params, server.theta, server.g_global, deltas, thetas,
        weights, cfg)
    return advance_server(server, new_params, new_theta, new_g,
                          aligned=thetas is not None)
