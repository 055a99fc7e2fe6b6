"""Synchronous federated runtime: client sampling, batch staging, round
loop — counterpart of ``repro/fed/rounds.py`` on the legacy dense path.

``FedConfig()`` defaults select the paper's main path: ``fedpac_soap``,
the sync runtime, the ``vmap`` executor and the dense transport, on the
GPU (``device="cuda"``, which raises on a host without one; pass
``device="cpu"`` for the plain PyTorch path).  The round draws from one
numpy generator in the reference's order — cohort, batches, then one
integer seed — so the same ``seed`` samples the same cohorts and batches
as the JAX runtime.  Population, pipeline and async modes are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np

from repro_torch import optim
from repro_torch.core import init_server
from repro_torch.core.algorithms import AlgorithmSpec, build_round_fn, resolve
from repro_torch.core.engine import (
    BETA_MAX_AUTO, ExecutorConfig, make_controller,
)
from repro_torch.fed.base import FedExperiment
from repro_torch.fed.staging import stage_cohort_batches
from repro_torch.utils.hw import resolve_device
from repro_torch.utils.tree import tree_map

RUNTIMES = ("sync",)


@dataclasses.dataclass
class FedConfig:
    algorithm: str = "fedpac_soap"
    n_clients: int = 20
    participation: float = 0.2     # fraction sampled per round
    rounds: int = 20
    local_steps: int = 10          # K
    batch_size: int = 16
    lr: Optional[float] = None     # default: paper's per-optimizer lr
    beta: Union[float, str] = 0.5  # FedPAC correction strength (or "auto")
    seed: int = 0
    server_lr: float = 1.0
    runtime: str = "sync"
    executor: str = "vmap"
    device: str = "cuda"

    def __post_init__(self):
        if not (0.0 < self.participation <= 1.0):
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")
        if self.runtime not in RUNTIMES:
            raise ValueError(
                f"unknown or unported runtime {self.runtime!r} (want one of "
                f"{RUNTIMES})")
        self.executor_config()
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {self.n_clients}")
        if self.local_steps < 1:
            raise ValueError(
                f"local_steps must be >= 1, got {self.local_steps}")
        if isinstance(self.beta, str) and self.beta != "auto":
            raise ValueError(
                f"beta must be a float or 'auto', got {self.beta!r}")
        resolve_device(self.device)

    def executor_config(self) -> ExecutorConfig:
        return ExecutorConfig(backend=self.executor)


def resolve_lr(fed: FedConfig, spec_or_opt: Union[AlgorithmSpec, str]
               ) -> float:
    """Explicit fed.lr wins (falsy values too), then the optimizer's
    paper-table default."""
    if fed.lr is not None:
        return fed.lr
    if isinstance(spec_or_opt, AlgorithmSpec):
        spec_or_opt = spec_or_opt.optimizer
    return optim.DEFAULT_LR[spec_or_opt]


class FederatedExperiment(FedExperiment):
    """Drives R lock-step communication rounds over client datasets.

    ``client_batch_fn(client_id, rng) -> batch dict`` supplies one local
    minibatch of numpy arrays; batches for a round stack to (S, K, ...) on
    ``fed.device``.  ``params`` move to that device.  ``spec`` (optional)
    supplies the algorithm directly; ``fed.algorithm`` is consulted when it
    is None.
    """

    def __init__(self, fed: FedConfig, params, loss_fn: Callable,
                 client_batch_fn: Callable, eval_fn: Optional[Callable] = None,
                 opt_kwargs: Optional[dict] = None,
                 spec: Optional[AlgorithmSpec] = None):
        super().__init__(fed)
        self.device = resolve_device(fed.device)
        self.spec = resolve(spec if spec is not None else fed.algorithm)
        self.loss_fn = loss_fn
        self.client_batch_fn = client_batch_fn
        self.eval_fn = eval_fn
        self.rng = np.random.default_rng(fed.seed)
        self.opt = self.spec.make_optimizer(**(opt_kwargs or {}))
        self.lr = resolve_lr(fed, self.spec)
        beta = self.spec.resolve_beta(fed.beta)
        self.transport = self.spec.make_transport()
        self.round_fn = build_round_fn(
            self.spec, loss_fn, self.opt, lr=self.lr,
            local_steps=fed.local_steps, beta=beta, server_lr=fed.server_lr,
            transport=self.transport, executor=fed.executor_config(),
            telemetry=True)
        geom = make_controller(beta, correct=self.spec.correct,
                               beta_max=BETA_MAX_AUTO, device=self.device)
        params = tree_map(lambda p: p.to(self.device), params)
        self.server = init_server(params, geom=geom)
        self.client_state = None

    def _sample_cohort(self):
        s = max(1, int(round(self.fed.n_clients * self.fed.participation)))
        return self.rng.choice(self.fed.n_clients, size=s, replace=False)

    def run_round(self):
        cohort = self._sample_cohort()
        batches = stage_cohort_batches(self.client_batch_fn, cohort,
                                       self.fed.local_steps, self.rng,
                                       self.device)
        # the reference draws a JAX key here; the draw keeps later
        # cohorts and batches in step with it
        seed = int(self.rng.integers(0, 2**31))
        self.server, self.client_state, metrics = self.round_fn(
            self.server, self.client_state, cohort, batches, seed)
        rec = {k: float(v) for k, v in metrics.items()}
        rec["round"] = self.server.round
        if self.eval_fn is not None:
            rec.update({k: float(v) for k, v in
                        self.eval_fn(self.server.params).items()})
        self.history.append(rec)
        return rec

    def comm_bytes_per_round(self) -> int:
        return self.transport.round_bytes(
            self.server.params,
            self.server.theta if self.spec.align else None)
