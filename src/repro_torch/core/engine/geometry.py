"""Geometry controller: adaptive correction strength carried in
``ServerState`` — counterpart of ``repro/core/engine/geometry.py``.

The drift-adaptive rule:

  d_r    = (1 - c) d_{r-1} + c * norm_drift_r      (EMA, c=1 => raw drift)
  beta_r = beta_max * d_r / (1 + d_r) * freshness

``beta`` and ``drift_ema`` are 0-d float32 tensors; the rule's
configuration (beta_max, adaptive, ema) is plain data.  Every
constructor takes the device its tensors live on as a required keyword: the
reference's controllers take none, and a default would put a GPU run's
controller on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

# cap for the drift-adaptive beta="auto" rule
BETA_MAX_AUTO = 0.7


@dataclasses.dataclass(frozen=True)
class GeometryController:
    beta: torch.Tensor              # correction strength used next round
    drift_ema: torch.Tensor         # smoothed normalized drift
    beta_max: float = BETA_MAX_AUTO
    adaptive: bool = False
    ema: float = 1.0                # EMA coefficient; 1.0 = no smoothing


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def fixed_controller(beta: float, *, device) -> GeometryController:
    """Constant-beta controller (fixed beta, FedCM, or no correction)."""
    return GeometryController(_f32(beta, device), _f32(0.0, device))


def auto_controller(beta_max: float = BETA_MAX_AUTO, ema: float = 1.0, *,
                    device) -> GeometryController:
    """Drift-adaptive controller; beta starts at 0 (no drift signal yet)."""
    return GeometryController(_f32(0.0, device), _f32(0.0, device),
                              beta_max=float(beta_max), adaptive=True,
                              ema=float(ema))


def update_controller(ctrl: GeometryController, norm_drift,
                      freshness=1.0) -> GeometryController:
    """One controller step. Fixed controllers pass through."""
    if not ctrl.adaptive:
        return ctrl
    d = ((1.0 - ctrl.ema) * ctrl.drift_ema
         + ctrl.ema * norm_drift).to(torch.float32)
    beta = (ctrl.beta_max * d / (1.0 + d) * freshness).to(torch.float32)
    return dataclasses.replace(ctrl, beta=beta, drift_ema=d)


def make_controller(beta, *, device, correct: bool = True,
                    beta_max: float = BETA_MAX_AUTO,
                    ema: float = 1.0) -> GeometryController:
    """The one beta rule: beta="auto" => adaptive; correct=False => beta
    pinned to 0."""
    if not correct:
        return fixed_controller(0.0, device=device)
    if beta == "auto":
        return auto_controller(beta_max=beta_max, ema=ema, device=device)
    return fixed_controller(float(beta), device=device)
