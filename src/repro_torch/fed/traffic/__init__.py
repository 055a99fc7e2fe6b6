"""Trace-driven continuous-traffic runtime (``repro_torch.fed.traffic``,
counterpart of ``repro/fed/traffic``).

Replaces "run N rounds" with "replay an arrival trace": open-ended client
event streams with churn, wall-clock/simulated-time budgets, anytime eval,
mid-stream checkpoint/rollback, and live algorithm hot-swap.  See
``runtime.TrafficExperiment`` for the execution model and ``traces`` for
the arrival/churn catalog.
"""
from repro_torch.fed.traffic.traces import (      # noqa: F401
    ArrivalProcess, BurstyRate, ChurnConfig, ConstantRate, DiurnalRate,
    Membership, PiecewiseRate, TRACES, make_trace,
)
from repro_torch.fed.traffic.runtime import (     # noqa: F401
    BUFFER_POLICIES, TrafficConfig, TrafficExperiment,
)
from repro_torch.fed.traffic.hotswap import (     # noqa: F401
    apply_swap, run_ab, time_to_quality,
)
