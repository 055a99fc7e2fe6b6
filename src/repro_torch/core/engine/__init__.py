"""Round engine: aggregation, geometry controller, cohort executor
(counterpart of ``repro/core/engine``)."""
from repro_torch.core.engine.aggregation import (  # noqa: F401
    AggregationConfig, advance_server, aggregate, aggregate_wire,
    finish_stream, precond_mixing_weights, stream_chunk,
)
from repro_torch.core.engine.executors import (  # noqa: F401
    BACKENDS, ExecutorConfig, make_cohort_executor,
)
from repro_torch.core.engine.geometry import (  # noqa: F401
    BETA_MAX_AUTO, GeometryController, auto_controller, fixed_controller,
    make_controller, update_controller,
)
