"""Buffered-asynchronous federated runtime with staleness-aware FedPAC
(counterpart of ``repro/fed/async_runtime``).

  latency.py     client latency/availability models (numpy)
  scheduler.py   event-driven simulated-time scheduler (numpy,
                 deterministic per seed)
  staleness.py   staleness-decay weight functions w(s)
  buffer.py      FedBuff-style buffered server flush (AsyncConfig)
  experiment.py  AsyncFederatedExperiment — drop-in FedExperiment
"""
from repro_torch.fed.async_runtime.latency import LatencyModel  # noqa: F401
from repro_torch.fed.async_runtime.scheduler import (  # noqa: F401
    Completion, SimScheduler,
)
from repro_torch.fed.async_runtime.staleness import (  # noqa: F401
    make_staleness_weight,
)
from repro_torch.fed.async_runtime.buffer import (  # noqa: F401
    AsyncConfig, make_async_aggregate_fn,
)
from repro_torch.fed.async_runtime.experiment import (  # noqa: F401
    AsyncFederatedExperiment,
)
