"""Federated runtimes (counterpart of ``repro/fed``): the sync runtime and
the buffered-asynchronous runtime."""
from repro_torch.fed.base import FedExperiment, make_experiment  # noqa: F401
from repro_torch.fed.rounds import (  # noqa: F401
    FedConfig, FederatedExperiment,
)
from repro_torch.fed.staging import (  # noqa: F401
    stage_client_batches, stage_cohort_batches,
)
from repro_torch.fed.async_runtime import (  # noqa: F401
    AsyncConfig, AsyncFederatedExperiment, LatencyModel,
)
