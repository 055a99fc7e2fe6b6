"""Million-client population layer (counterpart of
``repro/fed/population``): streaming cohorts over an abstract client-id
space, sparse per-client state with LRU spill through the checkpoint
store, and on-demand batch staging — the population size is a config
knob (``FedConfig.population_size``/``cohort_size``/``state_budget``)
whose cost scales with the cohort, not the id space."""
from repro_torch.fed.population.directory import (  # noqa: F401
    AvailabilitySampler, ClientPopulation, SAMPLERS, UniformSampler,
    WeightedSampler, hourly_availability, load_hourly_trace,
    make_population, resolve_population,
)
from repro_torch.fed.population.state import (  # noqa: F401
    ClientStateStore, DenseClientStore, make_client_store,
)
from repro_torch.fed.population.batches import (  # noqa: F401
    stage_client_population_batches, stage_population_batches,
)

__all__ = [
    "AvailabilitySampler", "ClientPopulation", "SAMPLERS", "UniformSampler",
    "WeightedSampler", "hourly_availability", "load_hourly_trace",
    "make_population", "resolve_population",
    "ClientStateStore", "DenseClientStore", "make_client_store",
    "stage_client_population_batches", "stage_population_batches",
]
