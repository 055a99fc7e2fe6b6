"""Declarative federated tasks (counterpart of ``repro/scenarios``):
``ScenarioSpec``/``PartitionSpec``, the registry and ``materialize``, and
the registered vision and LM catalog."""
from repro_torch.scenarios.spec import (  # noqa: F401
    DuplicateScenarioError, LAZY_PARTITION_KINDS, PARTITION_KINDS,
    PartitionSpec, Scenario,
    ScenarioSpec, UnknownScenarioError,
)
from repro_torch.scenarios.registry import (  # noqa: F401
    get, materialize, register, register_source, registered, resolve,
    resolve_source,
)
from repro_torch.scenarios.catalog import cifar_like, lm_zipf  # noqa: F401
