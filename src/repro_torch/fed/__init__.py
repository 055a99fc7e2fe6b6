"""Federated runtimes (counterpart of ``repro/fed``): the sync runtime,
the buffered-asynchronous runtime, the population layer and the
continuous-traffic runtime."""
from repro_torch.core.algorithms import (  # noqa: F401
    AlgorithmSpec, ClientStateSpec, register, registered, resolve,
)
from repro_torch.core.scaffold import ScaffoldState  # noqa: F401
from repro_torch.fed.base import FedExperiment, make_experiment  # noqa: F401
from repro_torch.fed.rounds import (  # noqa: F401
    FedConfig, FederatedExperiment, parse_algorithm,
)
from repro_torch.fed.staging import (  # noqa: F401
    stage_client_batches, stage_cohort_batches,
)
from repro_torch.fed.async_runtime import (  # noqa: F401
    AsyncConfig, AsyncFederatedExperiment, LatencyModel,
)
from repro_torch.fed.population import (  # noqa: F401
    AvailabilitySampler, ClientPopulation, ClientStateStore,
    DenseClientStore, UniformSampler, WeightedSampler, make_client_store,
    make_population, stage_population_batches,
)
from repro_torch.fed.traffic import (  # noqa: F401
    BurstyRate, ChurnConfig, ConstantRate, DiurnalRate, PiecewiseRate,
    TrafficConfig, TrafficExperiment,
)
