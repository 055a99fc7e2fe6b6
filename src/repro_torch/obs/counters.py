"""Counters where the work happens: monotone totals for the process, read
as one ``snapshot()`` (no counterpart in ``repro/obs``).

  launches.<wrapper>  the kernel wrappers' own ``<wrapper>.launches``
                      (``repro_torch.kernels``), read only for kernel
                      modules already imported, so a snapshot builds and
                      imports nothing
  omega.h2d_bytes     bytes of telemetry's JL projections copied to a card
                      and not kept there (``obs.telemetry.sketch_omega``:
                      past ``DEVICE_OMEGA_BYTES``, each use copies again)
  omega.draw_s        host seconds drawing those projections
                      (``obs.telemetry._omega``'s cache misses)

The counters are always on, at one add each, and hold no tensor.  An
enabled ``obs.trace.Tracer`` snapshots them when a round starts and when
it ends, puts the differences in the ``round`` event under ``counters``
and leaves them at ``last_traced_round()``, for readers that hold no
sink; a disabled tracer takes no snapshot.
"""
from __future__ import annotations

import sys
from typing import Optional

# (wrapper, module): the launch counters a snapshot reads
LAUNCH_COUNTERS = (
    ("adam_moments", "repro_torch.kernels.soap_rotate.kernel"),
    ("matmul_fused", "repro_torch.kernels.ns_ortho.kernel"),
    ("newton_schulz_group", "repro_torch.kernels.ns_ortho.ops"),
    ("householder_qr_group", "repro_torch.kernels.householder_qr.kernel"),
    ("quantize", "repro_torch.kernels.qblock.kernel"),
    ("dequant_accumulate", "repro_torch.kernels.fused_agg.kernel"),
    ("sophia_update", "repro_torch.kernels.sophia_update.kernel"),
)

_totals = {"omega.h2d_bytes": 0, "omega.draw_s": 0.0}
_last_traced_round: Optional[dict] = None


def add(name: str, amount) -> None:
    """Add ``amount`` to the process total ``name``."""
    _totals[name] += amount


def snapshot() -> dict:
    """Every counter's process total now."""
    out = dict(_totals)
    for wrapper, module in LAUNCH_COUNTERS:
        mod = sys.modules.get(module)
        if mod is not None:
            out[f"launches.{wrapper}"] = getattr(mod, wrapper).launches
    return out


def delta(before: dict, after: dict) -> dict:
    """``after - before`` by counter (a counter absent before counts from
    0: its module was imported in between)."""
    return {k: v - before.get(k, 0) for k, v in after.items()}


def record_traced_round(counts: dict) -> None:
    global _last_traced_round
    _last_traced_round = dict(counts)


def last_traced_round() -> Optional[dict]:
    """The counters' differences over the last round an enabled tracer
    recorded in this process (the ``round`` event's ``counters``); None
    before the first."""
    return None if _last_traced_round is None else dict(_last_traced_round)
