"""Buffered-asynchronous server: FedBuff-style flush with staleness-aware
FedPAC geometry handling (counterpart of
``repro/fed/async_runtime/buffer.py``).

The server holds version v and a buffer; client results (delta_i, Theta_i)
trained from version v_i accumulate until ``buffer_size`` arrive, then one
flush advances the model.  The flush is one call into the round engine
with staleness-decay weights w_i = w(v - v_i) in (0, 1]: the parameter
step shrinks with staleness (unnormalized FedBuff mean), while g_G and
Theta are freshness-mixed with rho = mean_i w_i — rho = 1 gives the
synchronous Alg. 2 update bitwise — and the drift-adaptive
``GeometryController`` steps in the same flush, with beta additionally
backed off by rho.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.engine import (
    AggregationConfig, aggregate, aggregate_wire, update_controller,
)
from repro_torch.core.transport import wire_bytes
from repro_torch.fed.async_runtime.latency import LatencyModel
from repro_torch.obs import telemetry as obs_telemetry


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Execution-model knobs of the buffered-asynchronous runtime."""
    buffer_size: int = 4           # flush after this many client reports
    concurrency: Optional[int] = None  # in-flight clients; None -> from
                                       # FedConfig.participation (>= buffer);
                                       # always clamped into [1, n_clients]
    staleness_mode: str = "poly"   # none | poly | hinge (staleness.py)
    staleness_alpha: float = 0.5   # w_i = 1/(1+s_i)^alpha for "poly"
    hinge_threshold: int = 2
    max_staleness: Optional[int] = None  # discard results staler than this
    latency: LatencyModel = dataclasses.field(default_factory=LatencyModel)

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError(
                f"buffer_size must be >= 1, got {self.buffer_size}")
        if self.concurrency is not None and self.concurrency < 1:
            raise ValueError(
                f"concurrency must be >= 1, got {self.concurrency}")
        if self.max_staleness is not None and self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}")

    def resolve_concurrency(self, n_clients: int, participation: float) -> int:
        c = self.concurrency
        if c is None:
            c = max(self.buffer_size,
                    int(round(n_clients * participation)))
        c = max(1, min(c, n_clients))
        if self.buffer_size > c:
            raise ValueError(
                f"buffer_size={self.buffer_size} exceeds the resolved "
                f"concurrency {c} (n_clients={n_clients}, "
                f"participation={participation}): the buffer could only "
                "fill from already-delivered stragglers — raise "
                "concurrency/participation or shrink buffer_size")
        return c


def make_async_aggregate_fn(*, lr: float, local_steps: int,
                            server_lr: float = 1.0, align: bool = True,
                            mixing=None, transport=None, wire_cell=None,
                            telemetry: bool = False):
    """Returns flush(params, theta, g_global, ctrl, deltas, thetas, weights,
    staleness=None) -> (params', theta', g_global', ctrl', metrics) over a
    client-stacked (B, ...) buffer: one engine aggregate and one
    controller step.

    With ``transport`` the buffer entries are stacked wire messages —
    deltas always, thetas too when ``align``.  Without a ``mixing`` hook
    the flush is fused: ``aggregate_wire`` reduces the encoded uploads
    straight into the weighted sums (for qblock, the grouped
    ``dequant_accumulate`` launches with the staleness weights); with
    ``mixing`` (which consumes decoded cohorts) the decode-then-aggregate
    path runs, the mixing weights multiplying the staleness weights.  The
    wire bytes go into the caller's ``wire_cell`` dict as the exact total
    (key "total") and the buffer size (key "cohort").  Without a
    transport the entries are dense trees.

    ``telemetry=True`` runs ``obs.telemetry.collect`` in the flush (the
    call the sync round makes, so zero-staleness telemetry equals the sync
    round's bitwise) and returns it under ``metrics["telemetry"]``;
    ``staleness`` is the buffer's (B,) integer staleness (None: all
    fresh)."""
    cfg = AggregationConfig(lr=lr, local_steps=local_steps,
                            server_lr=server_lr, align=align)
    fused = transport is not None and mixing is None

    def flush(params, theta, g_global, ctrl, deltas, thetas, weights,
              staleness=None):
        step = None
        if transport is not None:
            up_bytes = wire_bytes(deltas)
            if align:
                up_bytes += wire_bytes(thetas)
            if wire_cell is not None:
                wire_cell["total"] = up_bytes
                wire_cell["cohort"] = weights.shape[0]
        if fused:
            new_params, new_theta, new_g, agg, aux = aggregate_wire(
                params, theta, g_global, deltas, weights, cfg, transport,
                tmsgs=thetas if align else None,
                thetas=None if align else thetas,
                need_thetas=telemetry)
            deltas, thetas, step = None, aux["thetas"], aux["step"]
        else:
            if transport is not None:
                deltas = transport.delta.decode(deltas)
                if align:
                    thetas = transport.theta.decode(thetas)
            if mixing is not None:
                weights = weights * mixing(deltas, thetas)
            new_params, new_theta, new_g, agg = aggregate(
                params, theta, g_global, deltas, thetas, weights, cfg)
        # drift-adaptive rule, additionally backed off by the staleness of
        # the g_G estimate the next cohort will correct toward
        new_ctrl = update_controller(ctrl, agg["norm_drift"],
                                     agg["freshness"])
        metrics = dict(agg, loss=torch.zeros((), device=weights.device),
                       beta=ctrl.beta)   # the experiment fills in loss
        if telemetry:
            metrics["telemetry"] = obs_telemetry.collect(
                deltas=deltas, step=step, thetas=thetas, weights=weights,
                g_global=g_global, ctrl=ctrl, new_ctrl=new_ctrl,
                agg_metrics=agg, staleness=staleness)
        return new_params, new_theta, new_g, new_ctrl, metrics

    return flush
