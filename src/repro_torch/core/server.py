"""Server state for the federated runtime — counterpart of
``repro/core/server.py``.  ``theta_version`` records the round at which
Theta was last aggregated; ``geom`` carries the ``GeometryController``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils.tree import tree_map


@dataclasses.dataclass
class ServerState:
    params: Any
    theta: Any          # global preconditioner reference Theta^r (or None)
    g_global: Any       # estimated global direction g_G^r
    round: int = 0
    theta_version: int = 0   # round at which theta was last aggregated
    geom: Any = None         # GeometryController (or None)


def init_server(params, opt=None, g_dtype=torch.float32,
                geom=None) -> ServerState:
    """Round-0 state: no Theta reference yet, g_G = 0 in ``g_dtype``.
    ``opt`` is accepted and ignored, as the reference ignores it."""
    del opt
    g0 = tree_map(lambda p: torch.zeros(p.shape, dtype=g_dtype,
                                        device=p.device), params)
    return ServerState(params=params, theta=None, g_global=g0, round=0,
                       geom=geom)
