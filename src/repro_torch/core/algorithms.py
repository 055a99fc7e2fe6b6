"""First-class algorithm API: the ``AlgorithmSpec`` registry and the one
round path every algorithm runs through — counterpart of
``repro/core/algorithms.py``.

An algorithm is data: a frozen ``AlgorithmSpec`` declaring its local
optimizer, alignment/correction policy, beta policy and upload codecs.
``build_round_fn`` turns a spec into the uniform driver

    round_fn(server, client_state, cohort, batches, seed)
        -> (server, client_state, metrics)

on the fused wire path: the cohort's local rounds, the wire encode (with
error feedback for a lossy delta codec), and the wire-native server flush
(``engine.aggregate_wire``).  Ported so far: ``fedavg`` and ``fedcm``
(SGD; FedCM's beta pinned to 0.9), the ``local_*``, ``fedpac_*``,
``align_only_*`` and ``correct_only_*`` builtins of every ported
optimizer (SGD, AdamW, Muon, SOAP, Sophia), the dense and qblock codecs,
and error-feedback residuals as per-client state (``ClientStateSpec``,
without the population store's export/import hooks).  Algorithm state
(SCAFFOLD), mixing hooks (FedPM) and telemetry are not ported yet;
``telemetry=True`` is accepted and ignored.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Union

import torch

from repro_torch import optim
from repro_torch.core import transport as T
from repro_torch.core.client import LocalRunConfig, client_round
from repro_torch.core.engine import (
    AggregationConfig, ExecutorConfig, advance_server,
    aggregate_wire, make_cohort_executor, make_controller, update_controller,
)
from repro_torch.core.server import ServerState
from repro_torch.optim.api import LocalOptimizer
from repro_torch.utils.tree import tree_leaves, tree_map


class UnknownAlgorithmError(ValueError):
    """Name resolves to no registered ``AlgorithmSpec``."""


class DuplicateAlgorithmError(ValueError):
    """``register`` called twice for the same name without overwrite."""


@dataclasses.dataclass(frozen=True)
class ClientStateSpec:
    """Per-client persistent-state protocol (the reference's, without the
    population store's export/import hooks).  State is stacked with a
    leading (N,) client axis.

      init(params, n_clients)                     -> stacked state tree
      client_view(state, cohort)                  -> the cohort's rows
      server_update(state, cohort, outs, n)       -> new state

    ``outs`` is the cohort-stacked state output of the local round.
    """
    init: Callable[[Any, int], Any]
    client_view: Callable[[Any, Any], Any]
    server_update: Callable[[Any, Any, Any, int], Any]


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """One federated algorithm, declaratively.

    Correction strength comes from ``FedConfig.beta`` (0 when the
    algorithm does not correct).
    pinned_beta: algorithm-mandated correction strength overriding the
      user's ``FedConfig.beta`` (FedCM's (1 - alpha) = 0.9).
    default_lr: overrides the optimizer's table lr (``fed.lr`` still wins).
    """
    name: str
    optimizer: str = "sgd"
    align: bool = False
    correct: bool = False
    pinned_beta: Optional[float] = None
    upload: str = "dense"               # Theta codec spec
    delta_upload: str = "dense"         # delta codec spec
    default_lr: Optional[float] = None
    description: str = ""

    def __post_init__(self):
        T.validate_codec_spec(self.upload)
        T.validate_codec_spec(self.delta_upload)

    def resolve_beta(self, requested: Union[float, str]):
        """The one beta rule: no correction => 0; pinned (FedCM) wins;
        "auto" passes through to the adaptive controller."""
        if not self.correct:
            return 0.0
        if self.pinned_beta is not None:
            return float(self.pinned_beta)
        if requested == "auto":
            return "auto"
        return float(requested)

    def make_optimizer(self, **opt_kwargs) -> LocalOptimizer:
        return optim.make(self.optimizer, **opt_kwargs)

    def make_transport(self, *, block: int = 128, delta_codec=None,
                       theta_codec=None, error_feedback: bool = True
                       ) -> T.Transport:
        """This spec's wire policy: one codec per upload channel
        (``delta_codec``/``theta_codec`` override the spec's declared
        codec specs, e.g. from FedConfig)."""
        cfg = T.TransportConfig(block=block)
        return T.Transport(
            delta=T.resolve_codec(
                self.delta_upload if delta_codec is None else delta_codec,
                cfg),
            theta=T.resolve_codec(
                self.upload if theta_codec is None else theta_codec, cfg),
            error_feedback=error_feedback)


# ----------------------------------------------------------------- registry

_REGISTRY: dict[str, AlgorithmSpec] = {}


def register(spec: AlgorithmSpec, *, overwrite: bool = False) -> AlgorithmSpec:
    """Add ``spec`` to the registry; returns it for chaining."""
    if not isinstance(spec, AlgorithmSpec):
        raise TypeError(f"register wants an AlgorithmSpec, got {type(spec)}")
    if spec.optimizer not in optim.available():
        raise ValueError(
            f"spec {spec.name!r} names unknown optimizer {spec.optimizer!r} "
            f"(want one of {optim.available()})")
    if spec.name in _REGISTRY and not overwrite:
        raise DuplicateAlgorithmError(
            f"algorithm {spec.name!r} is already registered "
            "(pass overwrite=True to replace it)")
    _REGISTRY[spec.name] = spec
    return spec


def registered() -> tuple:
    """Sorted names of all registered algorithms."""
    return tuple(sorted(_REGISTRY))


def resolve(spec_or_name: Union[str, AlgorithmSpec]) -> AlgorithmSpec:
    """Spec passes through; strings resolve against the registry."""
    if isinstance(spec_or_name, AlgorithmSpec):
        return spec_or_name
    name = str(spec_or_name)
    if name not in _REGISTRY:
        raise UnknownAlgorithmError(
            f"unknown or unported algorithm {name!r}: registered specs are "
            f"{', '.join(registered())}")
    return _REGISTRY[name]


# -------------------------------------------------------- uniform round path

def zero_theta(opt: LocalOptimizer, params):
    """Fresh (zero) preconditioner tree for ``opt`` on ``params``: round 0
    has no global reference yet, so aligned clients align to this."""
    return tree_map(torch.zeros_like, opt.get_precond(opt.init(params)))


# error-feedback residuals, declared through the per-client state
# protocol: the round gathers the cohort's residuals and scatters the
# refreshed ones back
EF_STATE = ClientStateSpec(init=T.ef_init, client_view=T.ef_view,
                           server_update=lambda s, cohort, outs, n:
                           T.ef_scatter(s, cohort, outs))


def round_client_state_spec(spec: AlgorithmSpec,
                            transport: Optional[T.Transport] = None
                            ) -> Optional[ClientStateSpec]:
    """The per-client state protocol of one run: the transport's
    error-feedback residuals (lossy delta codec only) or None.  (Declared
    algorithm state, SCAFFOLD's, is not ported.)"""
    del spec
    if transport is not None and transport.feedback_active:
        return EF_STATE
    return None


def init_round_client_state(spec: AlgorithmSpec, transport, params,
                            n_clients: int):
    """Fresh state matching ``round_client_state_spec`` (None if stateless)."""
    proto = round_client_state_spec(spec, transport)
    return proto.init(params, n_clients) if proto is not None else None


def make_wire_client_step(spec: AlgorithmSpec, loss_fn: Callable,
                          opt: LocalOptimizer, run: LocalRunConfig,
                          transport: T.Transport, cohort_exec: Callable):
    """The cohort's round, from server state to wire messages:
    ``cohort_step(params, theta, g_global, beta, batches, residual, *,
    seed, probe_fn) -> (dmsg, tmsg, new_residual, loss)``.

    ``residual`` is the cohort's stacked error-feedback rows (None when
    feedback is off): it is added to the delta before encode, and the
    refreshed residual comes back for the scatter.  ``tmsg`` is the
    encoded stacked Theta for aligned algorithms, the dense stacked Theta
    tree otherwise."""
    def cohort_step(params, theta, g_global, beta, batches, residual=None,
                    *, seed=0, probe_fn=None):
        delta, theta_out, loss = client_round(
            loss_fn, opt, run, params, theta, g_global, batches, cohort_exec,
            beta=beta, seed=seed, probe_fn=probe_fn)
        dmsg, _, new_residual = T.encode_with_feedback(transport.delta,
                                                       delta, residual)
        tmsg = transport.theta.encode(theta_out) if spec.align else theta_out
        return dmsg, tmsg, new_residual, loss

    return cohort_step


def build_round_fn(
    spec: AlgorithmSpec,
    loss_fn: Callable,
    opt: LocalOptimizer,
    *,
    lr: float,
    local_steps: int,
    transport: T.Transport,
    beta: Union[float, str] = 0.5,
    hessian_freq: int = 10,
    server_lr: float = 1.0,
    executor: Optional[ExecutorConfig] = None,
    n_clients: Optional[int] = None,
    telemetry: bool = False,
    probe_fn: Optional[Callable] = None,
):
    """The one round implementation (fused wire path).

    Returns ``driver(server, client_state, cohort, batches, seed) ->
    (server, client_state, metrics)``; batches carry leading (S, K, ...)
    axes and ``cohort`` holds the (S,) client ids, by which the
    error-feedback rows of ``client_state`` are gathered and scattered
    (``n_clients`` sizes that state and is required when it exists).
    ``seed`` is the round's random draw: it seeds Sophia's Hutchinson
    probes, where the reference splits its round key.
    ``probe_fn(seed, k) -> stacked probe tree`` replaces those probes (the
    parity tests inject the reference's).  ``telemetry`` is accepted and
    ignored until ``obs`` is ported.
    """
    del telemetry
    state_proto = round_client_state_spec(spec, transport)
    if state_proto is not None and n_clients is None:
        raise ValueError(
            f"algorithm {spec.name!r} carries per-client state "
            "(error-feedback residuals); build_round_fn needs n_clients")
    run = LocalRunConfig(lr=lr, local_steps=local_steps,
                         hessian_freq=hessian_freq, align=spec.align)
    agg_cfg = AggregationConfig(lr=lr, local_steps=local_steps,
                                server_lr=server_lr, align=spec.align)
    cohort_step = make_wire_client_step(
        spec, loss_fn, opt, run, transport, make_cohort_executor(executor))

    def driver(server: ServerState, cstate, cohort, batches, seed):
        dev = tree_leaves(server.params)[0].device
        ctrl = server.geom if server.geom is not None else make_controller(
            beta, correct=spec.correct, device=dev)
        theta = server.theta
        if spec.align and theta is None:
            theta = zero_theta(opt, server.params)
        s = len(cohort)
        ids = torch.as_tensor(cohort, dtype=torch.long, device=dev)
        residual = (state_proto.client_view(cstate, ids)
                    if state_proto is not None else None)
        round_probes = (None if probe_fn is None else
                        functools.partial(probe_fn, seed))
        dmsgs, tmsgs, new_residual, loss = cohort_step(
            server.params, theta, server.g_global, ctrl.beta, batches,
            residual, seed=seed, probe_fn=round_probes)
        # exact host-side byte counts from the wire structures
        total = T.wire_bytes(dmsgs)
        if spec.align:
            total += T.wire_bytes(tmsgs)
        weights = torch.ones((s,), dtype=torch.float32, device=loss.device)
        params, new_theta, new_g, agg, _ = aggregate_wire(
            server.params, theta, server.g_global, dmsgs, weights, agg_cfg,
            transport, tmsgs=tmsgs if spec.align else None,
            thetas=None if spec.align else tmsgs)
        if state_proto is not None:
            cstate = state_proto.server_update(cstate, ids, new_residual,
                                               n_clients)
        new_ctrl = update_controller(ctrl, agg["norm_drift"],
                                     agg["freshness"])
        metrics = dict(agg, loss=loss, beta=ctrl.beta,
                       upload_bytes=total // s, upload_total_bytes=total,
                       cohort_size=s)
        new_server = advance_server(server, params, new_theta, new_g,
                                    geom=new_ctrl, aligned=spec.align)
        return new_server, cstate, metrics

    return driver


# ------------------------------------------------------- built-in algorithms

def _register_builtins():
    register(AlgorithmSpec(
        name="fedavg", optimizer="sgd",
        description="SGD locally, parameter averaging"))
    register(AlgorithmSpec(
        name="fedcm", optimizer="sgd", correct=True, pinned_beta=0.9,
        description="client momentum: correction-only SGD, beta pinned to "
                    "(1 - alpha) = 0.9"))
    for opt_name in optim.available():
        register(AlgorithmSpec(
            name=f"local_{opt_name}", optimizer=opt_name,
            description=f"FedSOA (Alg. 1) with {opt_name}: fresh local "
                        "state each round, parameter averaging"))
        register(AlgorithmSpec(
            name=f"fedpac_{opt_name}", optimizer=opt_name, align=True,
            correct=True,
            description=f"FedPAC (Alg. 2) with {opt_name}: preconditioner "
                        "Alignment + direction Correction"))
        register(AlgorithmSpec(
            name=f"align_only_{opt_name}", optimizer=opt_name, align=True,
            description="Table 5 ablation: Alignment without Correction"))
        register(AlgorithmSpec(
            name=f"correct_only_{opt_name}", optimizer=opt_name,
            correct=True,
            description="Table 5 ablation: Correction without Alignment"))


_register_builtins()
