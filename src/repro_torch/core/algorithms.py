"""First-class algorithm API: the ``AlgorithmSpec`` registry and the one
round path every algorithm runs through — counterpart of
``repro/core/algorithms.py``.

An algorithm is data: a frozen ``AlgorithmSpec`` declaring its local
optimizer, alignment/correction policy, beta policy and upload codecs.
``build_round_fn`` turns a spec into the uniform driver

    round_fn(server, client_state, cohort, batches, seed)
        -> (server, client_state, metrics)

on the fused dense path: the cohort's local rounds, dense wire encode, and
the wire-native server flush (``engine.aggregate_wire``).  Ported so far:
the SOAP builtins (``local_soap``, ``fedpac_soap``, ``align_only_soap``,
``correct_only_soap``).  Per-client state (SCAFFOLD, error feedback),
mixing hooks (FedPM) and telemetry are not ported yet; ``telemetry=True``
is accepted and ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

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
class AlgorithmSpec:
    """One federated algorithm, declaratively.

    Correction strength comes from ``FedConfig.beta`` (0 when the
    algorithm does not correct).
    """
    name: str
    optimizer: str = "soap"
    align: bool = False
    correct: bool = False
    upload: str = "dense"               # Theta codec spec
    delta_upload: str = "dense"         # delta codec spec
    description: str = ""

    def __post_init__(self):
        T.validate_codec_spec(self.upload)
        T.validate_codec_spec(self.delta_upload)

    def resolve_beta(self, requested: Union[float, str]):
        """The one beta rule: no correction => 0; "auto" passes through
        to the adaptive controller."""
        if not self.correct:
            return 0.0
        if requested == "auto":
            return "auto"
        return float(requested)

    def make_optimizer(self, **opt_kwargs) -> LocalOptimizer:
        return optim.make(self.optimizer, **opt_kwargs)

    def make_transport(self) -> T.Transport:
        """This spec's wire policy: one codec per upload channel."""
        return T.Transport(delta=T.resolve_codec(self.delta_upload),
                           theta=T.resolve_codec(self.upload))


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


def make_wire_client_step(spec: AlgorithmSpec, loss_fn: Callable,
                          opt: LocalOptimizer, run: LocalRunConfig,
                          transport: T.Transport, cohort_exec: Callable):
    """The cohort's round, from server state to wire messages:
    ``cohort_step(params, theta, g_global, beta, batches) -> (dmsg, tmsg,
    loss)``.  ``tmsg`` is the encoded stacked Theta for aligned algorithms,
    the dense stacked Theta tree otherwise."""
    def cohort_step(params, theta, g_global, beta, batches):
        delta, theta_out, loss = client_round(
            loss_fn, opt, run, params, theta, g_global, batches, cohort_exec,
            beta=beta)
        dmsg = transport.delta.encode(delta)
        tmsg = transport.theta.encode(theta_out) if spec.align else theta_out
        return dmsg, tmsg, loss

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
    server_lr: float = 1.0,
    executor: Optional[ExecutorConfig] = None,
    telemetry: bool = False,
):
    """The one round implementation (fused dense wire path).

    Returns ``driver(server, client_state, cohort, batches, seed) ->
    (server, client_state, metrics)``; batches carry leading (S, K, ...)
    axes.  ``seed`` is the round's random draw (kept so the caller's
    generator advances as the reference's does; SOAP draws nothing).
    ``telemetry`` is accepted and ignored until ``obs`` is ported.
    """
    del telemetry
    run = LocalRunConfig(lr=lr, local_steps=local_steps, align=spec.align)
    agg_cfg = AggregationConfig(lr=lr, local_steps=local_steps,
                                server_lr=server_lr, align=spec.align)
    cohort_step = make_wire_client_step(
        spec, loss_fn, opt, run, transport, make_cohort_executor(executor))

    def driver(server: ServerState, cstate, cohort, batches, seed):
        del seed
        ctrl = server.geom if server.geom is not None else make_controller(
            beta, correct=spec.correct,
            device=tree_leaves(server.params)[0].device)
        theta = server.theta
        if spec.align and theta is None:
            theta = zero_theta(opt, server.params)
        s = len(cohort)
        dmsgs, tmsgs, loss = cohort_step(server.params, theta,
                                         server.g_global, ctrl.beta, batches)
        # exact host-side byte counts from the wire structures
        total = T.wire_bytes(dmsgs)
        if spec.align:
            total += T.wire_bytes(tmsgs)
        weights = torch.ones((s,), dtype=torch.float32, device=loss.device)
        params, new_theta, new_g, agg, _ = aggregate_wire(
            server.params, theta, server.g_global, dmsgs, weights, agg_cfg,
            transport, tmsgs=tmsgs if spec.align else None,
            thetas=None if spec.align else tmsgs)
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
