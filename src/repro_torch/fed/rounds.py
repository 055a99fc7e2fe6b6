"""Synchronous federated runtime: client sampling, batch staging, round
loop — counterpart of ``repro/fed/rounds.py`` on the legacy (dense-id)
path.

``FedConfig()`` defaults select the paper's main path: ``fedpac_soap``,
the sync runtime, the ``vmap`` executor and the dense transport, on the
GPU (``device="cuda"``, which raises on a host without one; pass
``device="cpu"`` for the plain PyTorch path).  ``delta_codec`` /
``theta_codec`` select the upload codecs (``"dense"``, ``"lowrank_svd"``,
``"svd"``, ``"power_sketch"``, ``"qblock"`` or an ``"a+b"`` chain; None
keeps the spec's own), with ``svd_rank``, ``sketch_iters``,
``qblock_size`` and ``wire_dtype`` (``"f32"`` | ``"bf16"``) as their
knobs; with a lossy delta codec and ``error_feedback`` the run carries
stacked ``(N, ...)`` f32 residuals as per-client state, beside any state
the algorithm declares (SCAFFOLD's control variates).  The round draws
from one numpy generator in the reference's order — cohort, batches, then
one integer seed — so the same ``seed`` samples the same cohorts and
batches as the JAX runtime; that seed also seeds Sophia's Hutchinson
probes.
Population, pipeline and async modes are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np

from repro_torch import optim
from repro_torch.core import init_server
from repro_torch.core.algorithms import (
    AlgorithmSpec, build_round_fn, init_round_client_state, resolve,
)
from repro_torch.core.engine import (
    BETA_MAX_AUTO, ExecutorConfig, make_controller,
)
from repro_torch.core.transport import (
    Transport, validate_codec_spec, validate_wire_dtype,
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
    hessian_freq: int = 10
    svd_rank: int = 8              # low-rank codec rank (*_light variants)
    seed: int = 0
    server_lr: float = 1.0
    runtime: str = "sync"
    executor: str = "vmap"
    # geometry transport: None inherits the spec's declared codec specs
    theta_codec: Optional[str] = None
    delta_codec: Optional[str] = None
    error_feedback: bool = True    # EF residuals for lossy delta codecs
    qblock_size: int = 128         # qblock codec: elements per scale
    sketch_iters: int = 2          # power_sketch subspace iterations
    wire_dtype: str = "f32"        # wire payload dtype: "f32" (native,
    #                                lossless) | "bf16" (half-width uploads)
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
        if self.hessian_freq < 1:
            raise ValueError(
                f"hessian_freq must be >= 1, got {self.hessian_freq}")
        if isinstance(self.beta, str) and self.beta != "auto":
            raise ValueError(
                f"beta must be a float or 'auto', got {self.beta!r}")
        for codec_spec in (self.theta_codec, self.delta_codec):
            if codec_spec is not None:
                validate_codec_spec(codec_spec)  # UnknownCodecError early
        if self.svd_rank < 1:
            raise ValueError(f"svd_rank must be >= 1, got {self.svd_rank}")
        if self.qblock_size < 1:
            raise ValueError(
                f"qblock_size must be >= 1, got {self.qblock_size}")
        if resolve_device(self.device).type == "cuda" and \
                self.qblock_size % 128:
            raise ValueError(
                f"qblock_size must be a multiple of 128 on a CUDA device "
                f"(the quantize and dequant_accumulate kernels' block "
                f"granularity), got {self.qblock_size}")
        validate_wire_dtype(self.wire_dtype)
        if self.sketch_iters < 0:
            raise ValueError(
                f"sketch_iters must be >= 0, got {self.sketch_iters}")

    def executor_config(self) -> ExecutorConfig:
        return ExecutorConfig(backend=self.executor)

    def make_transport(self, spec: AlgorithmSpec) -> Transport:
        """Resolve the wire policy for ``spec`` under this config."""
        return spec.make_transport(
            rank=self.svd_rank, block=self.qblock_size,
            sketch_iters=self.sketch_iters, delta_codec=self.delta_codec,
            theta_codec=self.theta_codec,
            error_feedback=self.error_feedback, wire_dtype=self.wire_dtype)


def resolve_lr(fed: FedConfig, spec_or_opt: Union[AlgorithmSpec, str]
               ) -> float:
    """Explicit fed.lr wins (falsy values too), then the spec's declared
    default_lr, then the optimizer's paper-table default (1e-2 for an
    optimizer the table does not name)."""
    if fed.lr is not None:
        return fed.lr
    if isinstance(spec_or_opt, AlgorithmSpec):
        if spec_or_opt.default_lr is not None:
            return spec_or_opt.default_lr
        spec_or_opt = spec_or_opt.optimizer
    return optim.DEFAULT_LR.get(spec_or_opt, 1e-2)


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
        self.transport = fed.make_transport(self.spec)
        self.round_fn = build_round_fn(
            self.spec, loss_fn, self.opt, lr=self.lr,
            local_steps=fed.local_steps, beta=beta,
            hessian_freq=fed.hessian_freq, server_lr=fed.server_lr,
            transport=self.transport, executor=fed.executor_config(),
            n_clients=fed.n_clients, telemetry=True)
        geom = make_controller(beta, correct=self.spec.correct,
                               beta_max=BETA_MAX_AUTO, device=self.device)
        params = tree_map(lambda p: p.to(self.device), params)
        self.server = init_server(params, geom=geom)
        self.client_state = init_round_client_state(
            self.spec, self.transport, params, fed.n_clients)

    def _sample_cohort(self):
        s = max(1, int(round(self.fed.n_clients * self.fed.participation)))
        return self.rng.choice(self.fed.n_clients, size=s, replace=False)

    def run_round(self):
        cohort = self._sample_cohort()
        batches = stage_cohort_batches(self.client_batch_fn, cohort,
                                       self.fed.local_steps, self.rng,
                                       self.device)
        # the reference draws its round key here: the same integer seeds
        # this round's Hutchinson probes and keeps later draws in step
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
