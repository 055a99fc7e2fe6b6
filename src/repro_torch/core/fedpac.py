"""FedPAC (Alg. 2): Federated Preconditioner Alignment and Correction —
counterpart of ``repro/core/fedpac.py``.

``make_round_fn`` is the stateless entry point with the historical
``round_fn(server, batches, seed)`` signature: it builds an anonymous
``AlgorithmSpec`` for the requested (align, correct) combination and
adapts ``core.algorithms.build_round_fn`` — the one round implementation
— by fixing ``client_state=None`` and ``cohort=arange(S)``.  Registered
algorithms and per-client state go through ``build_round_fn`` directly.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

from repro_torch.core.algorithms import (
    AlgorithmSpec, build_round_fn, zero_theta,
)
from repro_torch.core.engine import BETA_MAX_AUTO, ExecutorConfig
from repro_torch.core.server import ServerState
from repro_torch.optim.api import LocalOptimizer

__all__ = ["make_round_fn", "zero_theta"]


def make_round_fn(
    loss_fn: Callable,
    opt: LocalOptimizer,
    *,
    lr: float,
    local_steps: int,
    beta: Union[float, str] = 0.5,
    align: bool = True,
    correct: bool = True,
    hessian_freq: int = 10,
    server_lr: float = 1.0,
    compress_fn=None,       # legacy stacked Theta round-trip
    transport=None,         # core.transport.Transport: wire codecs
    beta_max: float = BETA_MAX_AUTO,  # cap for beta="auto"
    drift_ema: float = 1.0,           # EMA coeff for beta="auto" (1 = raw)
    executor: Optional[ExecutorConfig] = None,
    telemetry: bool = False,
):
    """Returns round_fn(server_state, batches, seed) -> (server_state,
    metrics).

    batches: dict with leading (S, K, ...) axes (client, local step).
    ``align=False, correct=False`` is the naive FedSOA baseline of Alg. 1.
    ``beta="auto"`` enables drift-adaptive correction.  A transport whose
    lossy delta codec carries error feedback needs per-client state — use
    ``build_round_fn`` with ``n_clients`` for that.
    """
    spec = AlgorithmSpec(name=f"<inline:{opt.name}>", optimizer=opt.name,
                         align=align, correct=correct)
    driver = build_round_fn(
        spec, loss_fn, opt, lr=lr, local_steps=local_steps, beta=beta,
        hessian_freq=hessian_freq, server_lr=server_lr,
        compress_fn=compress_fn, transport=transport, beta_max=beta_max,
        drift_ema=drift_ema, executor=executor, telemetry=telemetry)

    def round_fn(server: ServerState, batches, seed):
        s = next(iter(batches.values())).shape[0]
        new_server, _, metrics = driver(server, None, list(range(s)),
                                        batches, seed)
        return new_server, metrics

    return round_fn
