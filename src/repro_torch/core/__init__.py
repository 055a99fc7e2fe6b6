"""Federated core (counterpart of ``repro/core``): client rounds, drift,
server state, the round engine, transport and the algorithm registry."""
from repro_torch.core.client import (  # noqa: F401
    LocalRunConfig, client_round, hutchinson_estimate,
)
from repro_torch.core.server import ServerState, init_server  # noqa: F401
from repro_torch.core.engine import (  # noqa: F401
    AggregationConfig, BETA_MAX_AUTO, ExecutorConfig, GeometryController,
    advance_server, aggregate, aggregate_round, auto_controller,
    fixed_controller, make_cohort_executor, make_controller,
    normalized_client_mean, precond_mixing_weights, update_controller,
    weighted_client_mean,
)
from repro_torch.core.algorithms import (  # noqa: F401
    AlgorithmSpec, ClientStateSpec, DuplicateAlgorithmError, EF_STATE,
    UnknownAlgorithmError, build_round_fn, init_round_client_state,
    make_local_update, register, registered, resolve,
    round_client_state_spec, zero_theta,
)
from repro_torch.core.transport import (  # noqa: F401
    Codec, Transport, TransportConfig, UnknownCodecError, WireMsg,
    registered_codecs, resolve_codec, wire_bytes,
)
from repro_torch.core.scaffold import ScaffoldState  # noqa: F401
from repro_torch.core.fedpac import make_round_fn  # noqa: F401
from repro_torch.core.fedsoa import (  # noqa: F401
    VARIANTS, make_fedsoa_round_fn, make_variant_round_fn,
)
from repro_torch.core import fedpm  # noqa: F401  (registers FedPM's specs)
from repro_torch.core.drift import (  # noqa: F401
    drift_metric, drift_per_layer, spectral_drift,
)
from repro_torch.core.compression import (  # noqa: F401
    compressed_bytes, make_svd_codec, round_comm_bytes, svd_truncate,
)
