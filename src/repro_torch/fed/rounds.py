"""Synchronous federated runtime: client sampling, batch staging, round
loop — counterpart of ``repro/fed/rounds.py``.

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
probes.  ``runtime="async"`` selects the buffered-asynchronous runtime
(``fed.async_runtime``).  ``executor`` picks the cohort executor
(``vmap``, ``chunked``, ``shard_map``, ``sharded``; ``chunk_size``).

Population mode (``population_size`` and ``cohort_size`` set, optionally
a ``population=`` carrying a weighted or availability sampler): cohorts
stream from an abstract id space (``fed.population``), each client's
batches come from its own generator and its Hutchinson probes from its
own seed (the round index is the salt), per-client state lives in a
budgeted sparse store (``state_budget``, ``spill_dir``) whose cold rows
spill through the checkpoint store, and the round fn receives slot
indices and the per-client seeds.  ``pipeline=True`` runs the round as a
chunk stream (``fed.pipeline``: ``pipeline_chunk`` clients a chunk,
``pipeline_workers`` stager threads); an algorithm with a mixing hook
falls back to the serial round with a ``RuntimeWarning``.  The legacy
path (``population_size=None``) keeps its shared-generator draw order.

A round is traced as a ``staging`` and an ``update`` span (population
staging splits into ``stage_batches`` and ``state_acquire``; a pipelined
round emits per-chunk spans), an ``eval`` span and one ``round`` event
carrying the round's ``Telemetry`` when sinks are attached
(``repro_torch.obs.attach``); the update span then waits for the device,
so an untraced round keeps its timing.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional, Union

import numpy as np

from repro_torch import optim
from repro_torch.core import init_server
from repro_torch.core.algorithms import (
    AlgorithmSpec, build_round_fn, init_round_client_state, resolve,
    round_client_state_spec,
)
from repro_torch.core.engine import (
    BETA_MAX_AUTO, ExecutorConfig, make_controller,
)
from repro_torch.core.transport import (
    Transport, validate_codec_spec, validate_wire_dtype,
)
from repro_torch.fed.base import FedExperiment
from repro_torch.fed.population import (
    SAMPLERS, make_client_store, resolve_population,
    stage_population_batches,
)
from repro_torch.fed.staging import stage_cohort_batches
from repro_torch.obs.telemetry import telemetry_dict
from repro_torch.utils.hw import resolve_device, synchronize
from repro_torch.utils.tree import tree_map

RUNTIMES = ("sync", "async")


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
    executor: str = "vmap"         # vmap | chunked | shard_map | sharded
    chunk_size: int = 8            # for executor="chunked"/"sharded"
    # ---- population scale-out (fed.population).  None -> legacy dense
    # path (n_clients dense lists, shared-generator draw order)
    population_size: Optional[int] = None  # abstract client-id space size
    cohort_size: Optional[int] = None      # clients a round (required in
    #                                        population mode)
    state_budget: Optional[int] = None     # resident client-state slots;
    #                                        None -> min(pop, 4 * cohort)
    cohort_sampler: str = "uniform"        # population cohort sampler name
    spill_dir: Optional[str] = None        # cold-state spill dir (None ->
    #                                        a fresh temp dir)
    # geometry transport: None inherits the spec's declared codec specs
    theta_codec: Optional[str] = None
    delta_codec: Optional[str] = None
    error_feedback: bool = True    # EF residuals for lossy delta codecs
    qblock_size: int = 128         # qblock codec: elements per scale
    sketch_iters: int = 2          # power_sketch subspace iterations
    wire_dtype: str = "f32"        # wire payload dtype: "f32" (native,
    #                                lossless) | "bf16" (half-width uploads)
    # ---- chunk-streaming pipelined rounds (fed.pipeline): population +
    # sync only
    pipeline: bool = False
    pipeline_chunk: int = 128      # clients a pipeline chunk
    pipeline_workers: int = 4      # background stager threads
    device: str = "cuda"

    def __post_init__(self):
        if not (0.0 < self.participation <= 1.0):
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")
        if self.runtime not in RUNTIMES:
            raise ValueError(
                f"unknown runtime {self.runtime!r} (want one of {RUNTIMES})")
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
        if self.pipeline_chunk < 1:
            raise ValueError(
                f"pipeline_chunk must be >= 1, got {self.pipeline_chunk}")
        if self.pipeline_workers < 1:
            raise ValueError(
                f"pipeline_workers must be >= 1, got "
                f"{self.pipeline_workers}")
        self._validate_population()
        if self.pipeline:
            if not self.population_active:
                raise ValueError(
                    "pipeline=True requires population mode (the chunked "
                    "cohort stream and sparse state store) — set "
                    "population_size/cohort_size as well")
            if self.runtime != "sync":
                raise ValueError(
                    "pipeline=True is a sync-runtime feature (the async "
                    "runtime already overlaps dispatches); use "
                    "runtime='sync'")

    def _validate_population(self):
        if self.population_size is None:
            pop_only = {"cohort_size": self.cohort_size,
                        "state_budget": self.state_budget,
                        "spill_dir": self.spill_dir}
            stray = [k for k, v in pop_only.items() if v is not None]
            if self.cohort_sampler != "uniform":
                stray.append("cohort_sampler")
            if stray:
                raise ValueError(
                    f"{', '.join(sorted(stray))} only apply to population "
                    "mode — set population_size as well")
            return
        if self.population_size < 1:
            raise ValueError(
                f"population_size must be >= 1, got {self.population_size}")
        if self.cohort_size is None:
            raise ValueError(
                "population mode needs an explicit cohort_size "
                "(participation fractions don't scale to 10^6-id spaces)")
        if not 1 <= self.cohort_size <= self.population_size:
            raise ValueError(
                f"cohort_size must be in [1, population_size="
                f"{self.population_size}], got {self.cohort_size}")
        if self.state_budget is not None and \
                self.state_budget < self.cohort_size:
            raise ValueError(
                f"state_budget {self.state_budget} < cohort_size "
                f"{self.cohort_size}: every cohort member needs a resident "
                "state slot")
        if self.cohort_sampler not in SAMPLERS:
            raise ValueError(
                f"unknown cohort_sampler {self.cohort_sampler!r} (config "
                f"strings support {sorted(SAMPLERS)}; pass a "
                "ClientPopulation for weighted/availability sampling)")

    @property
    def population_active(self) -> bool:
        return self.population_size is not None

    def resolve_state_budget(self) -> int:
        """Resident client-state slots: the explicit budget, else enough
        for a few cohorts of churn without population-sized memory."""
        if self.state_budget is not None:
            return self.state_budget
        return min(self.population_size, 4 * self.cohort_size)

    def executor_config(self) -> ExecutorConfig:
        return ExecutorConfig(backend=self.executor,
                              chunk_size=self.chunk_size)

    def make_transport(self, spec: AlgorithmSpec) -> Transport:
        """Resolve the wire policy for ``spec`` under this config."""
        return spec.make_transport(
            rank=self.svd_rank, block=self.qblock_size,
            sketch_iters=self.sketch_iters, delta_codec=self.delta_codec,
            theta_codec=self.theta_codec,
            error_feedback=self.error_feedback, wire_dtype=self.wire_dtype)


def parse_algorithm(name: str):
    """Legacy flag-tuple view of an algorithm string:
    ``(optimizer_name, align, correct, light)``.  Deprecated in favour of
    ``core.algorithms.resolve(name)``, whose spec also carries the beta
    policy, upload codec, client-state protocol and mixing hook."""
    spec = resolve(name)
    return spec.optimizer, spec.align, spec.correct, spec.upload == "svd"


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
    is None.  ``population`` (population mode only) is a
    ``fed.population.ClientPopulation``; the config builds a uniform one
    when it is None.
    """

    def __init__(self, fed: FedConfig, params, loss_fn: Callable,
                 client_batch_fn: Callable, eval_fn: Optional[Callable] = None,
                 opt_kwargs: Optional[dict] = None,
                 spec: Optional[AlgorithmSpec] = None,
                 population: Optional[object] = None):
        super().__init__(fed)
        self.device = resolve_device(fed.device)
        self.spec = resolve(spec if spec is not None else fed.algorithm)
        self.loss_fn = loss_fn
        self.client_batch_fn = client_batch_fn
        self.eval_fn = eval_fn
        self.rng = np.random.default_rng(fed.seed)
        self.population = resolve_population(fed, population)
        n_for_state = (fed.population_size if self.population is not None
                       else fed.n_clients)
        self.opt = self.spec.make_optimizer(**(opt_kwargs or {}))
        self.lr = resolve_lr(fed, self.spec)
        beta = self.spec.resolve_beta(fed.beta)
        self.transport = fed.make_transport(self.spec)
        self.round_fn = build_round_fn(
            self.spec, loss_fn, self.opt, lr=self.lr,
            local_steps=fed.local_steps, beta=beta,
            hessian_freq=fed.hessian_freq, server_lr=fed.server_lr,
            transport=self.transport, executor=fed.executor_config(),
            n_clients=n_for_state, telemetry=True)
        geom = make_controller(beta, correct=self.spec.correct,
                               beta_max=BETA_MAX_AUTO, device=self.device)
        params = tree_map(lambda p: p.to(self.device), params)
        self.server = init_server(params, geom=geom)
        self.state_store = None
        if self.population is not None:
            self.state_store = make_client_store(
                round_client_state_spec(self.spec, self.transport), params,
                fed.population_size, budget=fed.resolve_state_budget(),
                spill_dir=fed.spill_dir)
            self.client_state = (self.state_store.state
                                 if self.state_store is not None else None)
        else:
            self.client_state = init_round_client_state(
                self.spec, self.transport, params, fed.n_clients)
        self.pipeline = None
        if fed.pipeline:
            if self.spec.mixing is not None:
                warnings.warn(
                    f"algorithm {self.spec.name!r} has a mixing hook, "
                    "which needs the decoded cohort stack; pipeline=True "
                    "falls back to the serial round", RuntimeWarning,
                    stacklevel=2)
            else:
                from repro_torch.fed.pipeline import RoundPipeline
                self.pipeline = RoundPipeline(self)

    def _sample_cohort(self):
        s = max(1, int(round(self.fed.n_clients * self.fed.participation)))
        return self.rng.choice(self.fed.n_clients, size=s, replace=False)

    def _stage_population(self, round_index: int):
        """One population round's inputs: the streamed cohort, its batches
        and per-client seeds (the round index as the salt), and its state
        slots (``acquire`` materializes and restores rows)."""
        t = self.tracer
        pop = self.population
        cohort = pop.sample_cohort(round_index, self.fed.cohort_size)
        with t.span("stage_batches", round=round_index + 1):
            batches = stage_population_batches(
                self.client_batch_fn, pop, cohort, self.fed.local_steps,
                self.device, salt=round_index)
        seeds = pop.cohort_keys(cohort, salt=round_index)
        with t.span("state_acquire", round=round_index + 1):
            slots = (self.state_store.acquire(cohort)
                     if self.state_store is not None else cohort)
        return slots, batches, seeds

    def run_round(self):
        t = self.tracer
        rnum = self.server.round + 1   # the round this update produces
        if self.pipeline is not None:
            # the chunk stream emits its own spans and advances the
            # server and the client state itself
            metrics = self.pipeline.run_round()
        else:
            with t.span("staging", round=rnum):
                if self.population is not None:
                    cohort, batches, seed = self._stage_population(rnum - 1)
                else:
                    cohort = self._sample_cohort()
                    batches = stage_cohort_batches(
                        self.client_batch_fn, cohort, self.fed.local_steps,
                        self.rng, self.device)
                    # the reference draws its round key here: the same
                    # integer seeds this round's Hutchinson probes and
                    # keeps later draws in step
                    seed = int(self.rng.integers(0, 2**31))
            with t.span("update", round=rnum):
                cstate = (self.state_store.state
                          if self.state_store is not None
                          else self.client_state)
                self.server, self.client_state, metrics = self.round_fn(
                    self.server, cstate, cohort, batches, seed)
                if self.state_store is not None:
                    self.state_store.state = self.client_state
                if t.enabled:
                    synchronize(self.device)
        tele = metrics.pop("telemetry", None)
        self.last_telemetry = tele
        rec = {k: float(v) for k, v in metrics.items()}
        rec["round"] = self.server.round
        if self.state_store is not None:
            rec.update(state_resident=self.state_store.resident,
                       state_peak=self.state_store.peak_resident,
                       state_spills=self.state_store.spills,
                       state_restores=self.state_store.restores)
        if self.eval_fn is not None:
            with t.span("eval", round=rnum):
                rec.update({k: float(v) for k, v in
                            self.eval_fn(self.server.params).items()})
        if t.enabled:
            t.round_event(rec["round"], rec,
                          telemetry=telemetry_dict(tele) if tele is not None
                          else None)
        self.history.append(rec)
        return rec

    def comm_bytes_per_round(self) -> int:
        return self.transport.round_bytes(
            self.server.params,
            self.server.theta if self.spec.align else None)
