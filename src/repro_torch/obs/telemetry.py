"""Drift telemetry: the on-device diagnostics of one server update —
counterpart of ``repro/obs/telemetry.py``.

``Telemetry`` is a frozen dataclass of tensors on the run's device,
computed inside the round (sync) or flush (async) from exactly the
tensors the engine aggregates — no recomputation from history.  Because
both runtimes call the same ``collect`` with the same inputs, the
telemetry of a zero-staleness async flush is bitwise-identical to the
sync round's.

Fields:
  drift / norm_drift    preconditioner drift (Def. 1), raw and normalized
  freshness             rho = mean staleness weight (1.0 for sync rounds)
  beta / beta_next      correction strength used this round / next round
  drift_ema             the controller's smoothed drift after its update
  update_corr_cos       cos(aggregated step, -g_G)
  client_geom_dist      (S,) sketched ||Theta_i - mean_j Theta_j||^2 per
                        client through a fixed JL projection Omega
  staleness_hist        (STALENESS_BINS,) int32 histogram of the cohort's
                        staleness (all mass in bin 0 for a sync round)

Omega differs from the reference's: it draws leaf ``i``'s projection from
``jax.random.key(_SKETCH_KEY + i)``, bits the port cannot reproduce.  The
port draws it once per (leaf index, width, device) from a CPU generator
seeded with ``_SKETCH_KEY + i`` and moves it to the device
(``sketch_omega``), so a GPU and a CPU run project through the same Omega;
the parity tests replace ``sketch_omega`` with the reference's draws.
The draws are cached on the host: 8 floats per element of a client's
Theta (651 MB for ViT-Tiny SOAP's 20,348,928-float Theta, 27 GiB for
SmolLM-360M's 901,120,000).  A card keeps copies up to
``DEVICE_OMEGA_BYTES`` in all; a projection beyond that crosses to the
card for each use and is freed after it, so the sketch never holds a
transformer's projections on the card beside its training state.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.utils.tree import (
    client_weighted_sum, tree_dot, tree_leaves, tree_map, tree_norm_sq,
)

STALENESS_BINS = 8       # last bin catches s >= STALENESS_BINS - 1
SKETCH_RANK = 8
_SKETCH_KEY = 0xD81F7    # fixed: every round projects through the same Omega
DEVICE_OMEGA_BYTES = 2 << 30   # projections kept on a card, in all
_on_device: dict = {}


@dataclasses.dataclass(frozen=True)
class Telemetry:
    drift: torch.Tensor
    norm_drift: torch.Tensor
    freshness: torch.Tensor
    beta: torch.Tensor
    beta_next: torch.Tensor
    drift_ema: torch.Tensor
    update_corr_cos: torch.Tensor
    client_geom_dist: torch.Tensor    # (S,)
    staleness_hist: torch.Tensor      # (STALENESS_BINS,) int32


def staleness_histogram(staleness, bins: int = STALENESS_BINS):
    """Fixed-width int32 histogram of per-client staleness."""
    s = torch.clamp(torch.as_tensor(staleness).to(torch.int64), 0, bins - 1)
    return torch.bincount(s, minlength=bins).to(torch.int32)


def sketch_omega(index: int, width: int, rank: int, device):
    """Leaf ``index``'s fixed (width, rank) Gaussian projection, scaled by
    1/sqrt(rank); drawn once per (index, width, rank) on the host, and
    kept on another device while its copies there fit in
    ``DEVICE_OMEGA_BYTES``."""
    device = torch.device(device)
    omega = _omega(index, width, rank)
    if device.type == "cpu":
        return omega
    key = (index, width, rank, device)
    kept = _on_device.get(key)
    if kept is not None:
        return kept
    kept = omega.to(device)
    if (sum(x.nbytes for x in _on_device.values()) + kept.nbytes
            <= DEVICE_OMEGA_BYTES):
        _on_device[key] = kept
    return kept


@functools.lru_cache(maxsize=None)
def _omega(index: int, width: int, rank: int):
    gen = torch.Generator().manual_seed(_SKETCH_KEY + index)
    return torch.randn((width, rank), generator=gen) / math.sqrt(rank)


def client_geom_dist(thetas, s: int, rank: int = SKETCH_RANK, *, device):
    """(S,) sketched squared distance of each client's geometry to the
    cohort mean.  Leaves wider than ``rank`` are projected through the
    fixed Omega, so the squared distance is an unbiased JL estimate of the
    dense one; narrow leaves are exact.  thetas=None (first-order
    algorithms) reports zeros on ``device``."""
    total = torch.zeros((s,), dtype=torch.float32, device=device)
    if thetas is None:
        return total
    for i, leaf in enumerate(tree_leaves(thetas)):
        x = leaf.to(torch.float32).reshape(leaf.shape[0], -1)
        if x.shape[1] > rank:
            x = x @ sketch_omega(i, x.shape[1], rank, x.device)
        c = x - torch.mean(x, dim=0, keepdim=True)
        total = total + torch.sum(c * c, dim=-1)
    return total


def collect(*, deltas=None, step=None, thetas, weights, g_global, ctrl,
            new_ctrl, agg_metrics, staleness=None) -> Telemetry:
    """Assemble one round's ``Telemetry`` from the engine's own tensors.

    Call after ``engine.aggregate``/``aggregate_wire`` and
    ``update_controller`` with the same decoded ``deltas``/``thetas`` and
    final ``weights`` the aggregate saw, the pre-round controller ``ctrl``
    and post-update ``new_ctrl``, and the aggregate's metrics.  The fused
    wire path passes the already-reduced weighted mean as ``step`` instead
    of ``deltas``.  ``staleness`` is the (S,) integer staleness vector;
    None means a synchronous cohort (all zeros).
    """
    if (deltas is None) == (step is None):
        raise ValueError("pass exactly one of deltas (stacked cohort) or "
                         "step (precomputed weighted client mean)")
    w = weights.to(torch.float32)
    s = w.shape[0]
    if step is None:
        step = tree_map(lambda x: x / s, client_weighted_sum(deltas, w))
    cos = (-tree_dot(step, g_global)
           / (torch.sqrt(tree_norm_sq(step) * tree_norm_sq(g_global))
              + 1e-12))
    if staleness is None:
        staleness = torch.zeros((s,), dtype=torch.int32, device=w.device)
    return Telemetry(
        drift=agg_metrics["drift"].to(torch.float32),
        norm_drift=agg_metrics["norm_drift"].to(torch.float32),
        freshness=agg_metrics["freshness"].to(torch.float32),
        beta=ctrl.beta.to(torch.float32),
        beta_next=new_ctrl.beta.to(torch.float32),
        drift_ema=new_ctrl.drift_ema.to(torch.float32),
        update_corr_cos=cos.to(torch.float32),
        client_geom_dist=client_geom_dist(thetas, s, device=w.device),
        staleness_hist=staleness_histogram(staleness))


def telemetry_dict(t: Telemetry) -> dict:
    """Host-side view for trace events: floats + plain lists."""
    return {
        "drift": float(t.drift),
        "norm_drift": float(t.norm_drift),
        "freshness": float(t.freshness),
        "beta": float(t.beta),
        "beta_next": float(t.beta_next),
        "drift_ema": float(t.drift_ema),
        "update_corr_cos": float(t.update_corr_cos),
        "client_geom_dist": [float(x) for x in t.client_geom_dist.tolist()],
        "staleness_hist": [int(x) for x in t.staleness_hist.tolist()],
    }
