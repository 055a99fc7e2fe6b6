"""Federated core (counterpart of ``repro/core``): client rounds, drift,
server state, the round engine, transport and the algorithm registry."""
from repro_torch.core.server import ServerState, init_server  # noqa: F401
