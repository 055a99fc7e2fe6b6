"""First-class algorithm API: the ``AlgorithmSpec`` registry and the one
round path every algorithm runs through — counterpart of
``repro/core/algorithms.py``.

An algorithm is data: a frozen ``AlgorithmSpec`` declaring its local
optimizer, alignment/correction policy, beta policy, upload codecs,
per-client persistent state, aggregation mixing weights and comm
accounting.  ``build_round_fn`` turns a spec into the uniform driver

    round_fn(server, client_state, cohort, batches, seed)
        -> (server, client_state, metrics)

so SCAFFOLD's control variates (``core.scaffold``) and FedPM's
preconditioned mixing (``core.fedpm``) run through the same engine path
as FedPAC.  With a transport, the round is the fused wire path: the
cohort's local rounds, the wire encode (with error feedback for a lossy
delta codec), and the wire-native server flush
(``engine.aggregate_wire``); an algorithm with a ``mixing`` hook decodes
the cohort and takes ``engine.aggregate``.  Without a transport the round
aggregates the dense stacks, after the legacy ``compress_fn`` Theta
round-trip when one is given.

Builtins: ``fedavg``, ``fedcm`` (FedCM's beta pinned to 0.9), the
``local_*``, ``fedpac_*``, ``align_only_*`` and ``correct_only_*`` of
every optimizer (SGD, AdamW, Muon, SOAP, Sophia), ``scaffold``,
``fedpm_{adamw,sophia,muon,soap}``, and ``<registered>_light`` (the
rank-r SVD Theta upload), derived on resolution.  ``telemetry=True``
adds the round's ``obs.telemetry.Telemetry`` to its metrics.  The round
is traced on the live tracer (``obs.trace.current()``): the cohort's
local steps and upload encode as ``local_update``, the wire codecs inside
it as ``encode``.
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
    AggregationConfig, BETA_MAX_AUTO, ExecutorConfig, advance_server,
    aggregate, aggregate_wire, make_cohort_executor, make_controller,
    update_controller,
)
from repro_torch.core.server import ServerState
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs.trace import current as current_tracer
from repro_torch.optim.api import LocalOptimizer
from repro_torch.utils.tree import tree_leaves, tree_map


class UnknownAlgorithmError(ValueError):
    """Name resolves to no registered ``AlgorithmSpec``."""


class DuplicateAlgorithmError(ValueError):
    """``register`` called twice for the same name without overwrite."""


@dataclasses.dataclass(frozen=True)
class ClientStateSpec:
    """Per-client persistent-state protocol.  State is stacked with a
    leading (N,) client axis on the run's device.

      init(params, n_clients)                     -> stacked state tree
      client_view(state, cohort)                  -> the cohort's rows
      server_update(state, cohort, outs, n)       -> new state

    ``cohort`` is the (S,) tensor of client ids and ``outs`` the
    cohort-stacked state output of the local update.

    ``client_export``/``client_import``/``client_import_many`` are the
    sparse population's spill hooks: one client's private row out of the
    stacked state, and one or many rows grafted back in.  They default to
    the generic stacked-leaf slice and write, right whenever every leaf
    carries the (N,) axis (error-feedback residuals do); states that mix
    rows with shared globals (SCAFFOLD's ``c_global``) override them.  Use
    ``state_export``/``state_import``/``state_import_many``.  Unlike the
    reference's functional ``.at[].set``, grafts write in place: the
    stacked state is as large as N copies of the model.
    """
    init: Callable[[Any, int], Any]
    client_view: Callable[[Any, Any], Any]
    server_update: Callable[[Any, Any, Any, int], Any]
    client_export: Optional[Callable[[Any, Any], Any]] = None
    client_import: Optional[Callable[[Any, Any, Any], Any]] = None
    client_import_many: Optional[Callable[[Any, Any, Any], Any]] = None


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """One federated algorithm, declaratively.

    local_update: factory ``(spec, loss_fn, opt, run) -> local_fn`` with
      ``local_fn(params, theta, g_global, *, beta, view, batches,
      cohort_exec, seed, probe_fn) -> (delta, theta_out_or_None,
      client_out_or_None, loss)`` over the whole cohort (``view`` holds
      its gathered state rows, ``batches`` and the outputs keep the
      leading (S,) axis); None selects ``core.client.client_round``.
    client_state: the ``ClientStateSpec`` of the algorithm's own state.
    mixing: per-client aggregation weights ``(deltas, thetas) -> (S,)``
      for the delta mean (``engine.precond_mixing_weights``); needs the
      decoded cohort, so it takes decode-then-``aggregate``.
    pinned_beta: algorithm-mandated correction strength overriding the
      user's ``FedConfig.beta`` (FedCM's (1 - alpha) = 0.9).
    default_lr: overrides the optimizer's table lr (``fed.lr`` still wins).
    """
    name: str
    optimizer: str = "sgd"
    align: bool = False
    correct: bool = False
    pinned_beta: Optional[float] = None
    upload: str = "dense"               # Theta codec spec ("svd": low-rank)
    delta_upload: str = "dense"         # delta codec spec
    local_update: Optional[Callable] = None
    client_state: Optional[ClientStateSpec] = None
    mixing: Optional[Callable] = None
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

    def make_transport(self, *, rank: int = 8, block: int = 128,
                       sketch_iters: int = 2, delta_codec=None,
                       theta_codec=None, error_feedback: bool = True,
                       wire_dtype: str = "f32") -> T.Transport:
        """This spec's wire policy: one codec per upload channel
        (``delta_codec``/``theta_codec`` override the spec's declared
        codec specs, e.g. from FedConfig).  ``wire_dtype`` caps floating
        payload dtypes on the wire ("f32" native | "bf16")."""
        cfg = T.TransportConfig(rank=rank, block=block,
                                sketch_iters=sketch_iters,
                                wire_dtype=wire_dtype)
        return T.Transport(
            delta=T.resolve_codec(
                self.delta_upload if delta_codec is None else delta_codec,
                cfg),
            theta=T.resolve_codec(
                self.upload if theta_codec is None else theta_codec, cfg),
            error_feedback=error_feedback)

    def init_client_state(self, params, n_clients: int):
        """Fresh persistent state (None for stateless algorithms)."""
        if self.client_state is None:
            return None
        return self.client_state.init(params, n_clients)

    def comm_bytes(self, params, theta, *, svd_rank: Optional[int] = None
                   ) -> int:
        """Per-client upload bytes for one round (Table 6 accounting),
        measured from the wire messages this spec's default transport
        encodes for one client's trees."""
        transport = self.make_transport(rank=svd_rank or 8)
        return transport.round_bytes(params, theta if self.align else None)

    def light(self) -> "AlgorithmSpec":
        """Derived ``<name>_light`` variant: rank-r SVD Theta upload."""
        return dataclasses.replace(self, name=f"{self.name}_light",
                                   upload="svd")


# ----------------------------------------------------------------- registry

_REGISTRY: dict[str, AlgorithmSpec] = {}
_BUILTINS_LOADED = False


def _ensure_builtins():
    """Import the modules that register SCAFFOLD and FedPM (idempotent;
    lazy, so this module stays free of import cycles)."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    from repro_torch.core import fedpm, scaffold  # noqa: F401
    _BUILTINS_LOADED = True   # only after the imports succeed


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
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def get(name: str) -> AlgorithmSpec:
    """The registered spec ``name``, or ``<registered>_light`` derived."""
    _ensure_builtins()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.endswith("_light"):
        base = name[: -len("_light")]
        if base in _REGISTRY:
            return _REGISTRY[base].light()
    raise UnknownAlgorithmError(
        f"unknown algorithm {name!r}: registered specs are "
        f"{', '.join(registered())} (append '_light' for the rank-r SVD "
        "Theta upload)")


def resolve(spec_or_name: Union[str, AlgorithmSpec]) -> AlgorithmSpec:
    """Spec passes through; strings resolve against the registry."""
    if isinstance(spec_or_name, AlgorithmSpec):
        return spec_or_name
    return get(str(spec_or_name))


# -------------------------------------------------------- client state

def _put(x, idx, row):
    x[idx] = row.to(x.dtype)
    return x


def state_export(proto: ClientStateSpec, state, cid):
    """One client's private state row (what a population store spills)."""
    if proto.client_export is not None:
        return proto.client_export(state, cid)
    return tree_map(lambda x: x[cid], state)


def state_import(proto: ClientStateSpec, state, cid, row):
    """Graft a private row (from ``state_export``) back in at ``cid``."""
    if proto.client_import is not None:
        return proto.client_import(state, cid, row)
    return tree_map(lambda x, r: _put(x, cid, r), state, row)


def state_import_many(proto: ClientStateSpec, state, cids, rows):
    """Graft many private rows (stacked along a leading axis aligned with
    ``cids``) in one scatter; specs that override ``client_import``
    without a batched variant graft them one by one."""
    if proto.client_import_many is not None:
        return proto.client_import_many(state, cids, rows)
    if proto.client_import is not None:
        for i, cid in enumerate(torch.as_tensor(cids).tolist()):
            state = proto.client_import(
                state, cid, tree_map(lambda x: x[i], rows))
        return state
    ids = torch.as_tensor(cids, dtype=torch.long)
    return tree_map(lambda x, r: _put(x, ids, r), state, rows)


# error-feedback residuals, declared through the same per-client state
# protocol as algorithm state: the round gathers the cohort's residuals
# and scatters the refreshed ones back
EF_STATE = ClientStateSpec(init=T.ef_init, client_view=T.ef_view,
                           server_update=lambda s, cohort, outs, n:
                           T.ef_scatter(s, cohort, outs))


def _compose_state_specs(algo: ClientStateSpec,
                         ef: ClientStateSpec) -> ClientStateSpec:
    """Pair algorithm state with transport (EF) state: one protocol, two
    independently scattered slots."""
    return ClientStateSpec(
        init=lambda p, n: (algo.init(p, n), ef.init(p, n)),
        client_view=lambda s, cid: (algo.client_view(s[0], cid),
                                    ef.client_view(s[1], cid)),
        server_update=lambda s, cohort, outs, n: (
            algo.server_update(s[0], cohort, outs[0], n),
            ef.server_update(s[1], cohort, outs[1], n)),
        client_export=lambda s, cid: (state_export(algo, s[0], cid),
                                      state_export(ef, s[1], cid)),
        client_import=lambda s, cid, row: (
            state_import(algo, s[0], cid, row[0]),
            state_import(ef, s[1], cid, row[1])),
        client_import_many=lambda s, cids, rows: (
            state_import_many(algo, s[0], cids, rows[0]),
            state_import_many(ef, s[1], cids, rows[1])))


def round_client_state_spec(spec: AlgorithmSpec,
                            transport: Optional[T.Transport] = None
                            ) -> Optional[ClientStateSpec]:
    """The per-client state protocol of one run: the algorithm's declared
    state, the transport's error-feedback residuals (lossy delta codec
    only), their composition, or None."""
    ef = EF_STATE if (transport is not None
                      and transport.feedback_active) else None
    algo = spec.client_state
    if ef is None:
        return algo
    if algo is None:
        return ef
    return _compose_state_specs(algo, ef)


def init_round_client_state(spec: AlgorithmSpec, transport, params,
                            n_clients: int):
    """Fresh state matching ``round_client_state_spec`` (None if stateless)."""
    proto = round_client_state_spec(spec, transport)
    return proto.init(params, n_clients) if proto is not None else None


# -------------------------------------------------------- uniform round path

def zero_theta(opt: LocalOptimizer, params):
    """Fresh (zero) preconditioner tree for ``opt`` on ``params``: round 0
    has no global reference yet, so aligned clients align to this."""
    return tree_map(torch.zeros_like, opt.get_precond(opt.init(params)))


def make_local_update(spec: AlgorithmSpec, loss_fn: Callable,
                      opt: LocalOptimizer, run: LocalRunConfig) -> Callable:
    """The spec's cohort local update; defaults to ``client_round``."""
    if spec.local_update is not None:
        return spec.local_update(spec, loss_fn, opt, run)

    def local_fn(params, theta, g_global, *, beta, view, batches,
                 cohort_exec, seed=0, probe_fn=None):
        del view  # stateless
        delta, theta_out, loss = client_round(
            loss_fn, opt, run, params, theta, g_global, batches, cohort_exec,
            beta=beta, seed=seed, probe_fn=probe_fn)
        return delta, theta_out, None, loss

    return local_fn


def make_wire_client_step(spec: AlgorithmSpec, local_fn: Callable,
                          transport: Optional[T.Transport],
                          state_proto: Optional[ClientStateSpec], *,
                          fused: bool, cohort_exec: Callable) -> Callable:
    """The cohort's round, from state view to wire messages:
    ``cohort_step(params, theta, g_global, beta, cstate, cohort, batches,
    *, seed, probe_fn) -> (dchan, tmsg, out, loss)``.

    ``dchan`` is the encoded delta (error-compensated for a lossy codec
    with feedback on), paired with its decode on the decode-then-aggregate
    path (``fused=False``) when feedback computed it anyway; ``tmsg`` the
    encoded stacked Theta of aligned algorithms, the dense stacked Theta
    otherwise; ``out`` the new state rows (algorithm state, residuals, or
    both as a pair).  Without a transport the dense stacks pass through.
    """
    ef_active = transport is not None and transport.feedback_active
    has_algo_state = spec.client_state is not None
    encode_theta = transport is not None and spec.align

    def cohort_step(params, theta, g_global, beta, cstate, cohort, batches,
                    *, seed=0, probe_fn=None):
        view = (state_proto.client_view(cstate, cohort)
                if state_proto is not None else None)
        if ef_active:
            algo_view, residual = view if has_algo_state else (None, view)
        else:
            algo_view, residual = view, None
        delta, theta_out, algo_out, loss = local_fn(
            params, theta, g_global, beta=beta, view=algo_view,
            batches=batches, cohort_exec=cohort_exec, seed=seed,
            probe_fn=probe_fn)
        if transport is None:
            return delta, theta_out, algo_out, loss
        with current_tracer().span("encode"):
            dmsg, decoded, new_residual = T.encode_with_feedback(
                transport.delta, delta, residual)
            tmsg = (transport.theta.encode(theta_out) if encode_theta
                    else theta_out)
        dchan = (dmsg, decoded) if (ef_active and not fused) else dmsg
        if ef_active:
            out = ((algo_out, new_residual) if has_algo_state
                   else new_residual)
        else:
            out = algo_out
        return dchan, tmsg, out, loss

    return cohort_step


def build_round_fn(
    spec: AlgorithmSpec,
    loss_fn: Callable,
    opt: LocalOptimizer,
    *,
    lr: float,
    local_steps: int,
    beta: Union[float, str] = 0.5,
    hessian_freq: int = 10,
    server_lr: float = 1.0,
    compress_fn: Optional[Callable] = None,
    transport: Optional[T.Transport] = None,
    beta_max: float = BETA_MAX_AUTO,
    drift_ema: float = 1.0,
    executor: Optional[ExecutorConfig] = None,
    n_clients: Optional[int] = None,
    telemetry: bool = False,
    probe_fn: Optional[Callable] = None,
):
    """The one round implementation, for every registered algorithm.

    Returns ``driver(server, client_state, cohort, batches, seed) ->
    (server, client_state, metrics)``; batches carry leading (S, K, ...)
    axes and ``cohort`` holds the (S,) client ids, by which the rows of
    ``client_state`` are gathered and scattered (``n_clients`` sizes that
    state and is required when it exists).

    ``transport`` routes the uploads through wire codecs: the server runs
    the fused flush (``engine.aggregate_wire``) and reports the measured
    ``upload_bytes``; algorithms with a ``mixing`` hook decode the cohort
    and take ``engine.aggregate``.  ``compress_fn`` is the legacy stacked
    Theta round-trip (exclusive with ``transport``); None for both is the
    plain dense path.  ``seed`` is the round's random draw: it seeds
    Sophia's Hutchinson probes, where the reference splits its round key.
    ``probe_fn(seed, k) -> stacked probe tree`` replaces those probes (the
    parity tests inject the reference's).  ``telemetry=True`` computes the
    round's ``Telemetry`` (``obs.telemetry.collect``, the call the async
    flush makes, so a zero-staleness flush's telemetry equals the sync
    round's bitwise) and returns it under ``metrics["telemetry"]``; on a
    lossy Theta codec the fused flush then decodes the stacked Theta for
    the geometry sketch.
    """
    if transport is not None and compress_fn is not None:
        raise ValueError("pass either transport or the legacy compress_fn, "
                         "not both")
    state_proto = round_client_state_spec(spec, transport)
    ef_active = transport is not None and transport.feedback_active
    has_algo_state = spec.client_state is not None
    if state_proto is not None and n_clients is None:
        what = ("declared algorithm state" if has_algo_state
                else "error-feedback residuals")
        raise ValueError(
            f"algorithm {spec.name!r} carries per-client state ({what}); "
            "build_round_fn needs n_clients")
    encode_theta = transport is not None and spec.align
    # the fused wire path needs no decoded cohort; mixing hooks consume
    # the decoded stacks, so they keep the decode-then-aggregate path
    fused = transport is not None and spec.mixing is None
    run = LocalRunConfig(lr=lr, local_steps=local_steps,
                         hessian_freq=hessian_freq, align=spec.align)
    agg_cfg = AggregationConfig(lr=lr, local_steps=local_steps,
                                server_lr=server_lr, align=spec.align)
    cohort_step = make_wire_client_step(
        spec, make_local_update(spec, loss_fn, opt, run), transport,
        state_proto, fused=fused,
        cohort_exec=make_cohort_executor(executor))

    def driver(server: ServerState, cstate, cohort, batches, seed):
        dev = tree_leaves(server.params)[0].device
        ctrl = server.geom if server.geom is not None else make_controller(
            beta, correct=spec.correct, beta_max=beta_max, ema=drift_ema,
            device=dev)
        theta = server.theta
        if spec.align and theta is None:
            theta = zero_theta(opt, server.params)
        s = len(cohort)
        ids = torch.as_tensor(cohort, dtype=torch.long, device=dev)
        round_probes = (None if probe_fn is None else
                        functools.partial(probe_fn, seed))
        with current_tracer().span("local_update"):
            dchan, thetas, outs, loss = cohort_step(
                server.params, theta, server.g_global, ctrl.beta, cstate,
                ids, batches, seed=seed, probe_fn=round_probes)
        weights = torch.ones((s,), dtype=torch.float32, device=loss.device)
        total = None
        step = deltas = None
        if fused:
            # exact host-side byte counts from the wire structures
            total = T.wire_bytes(dchan)
            if encode_theta:
                total += T.wire_bytes(thetas)
            params, new_theta, new_g, agg, aux = aggregate_wire(
                server.params, theta, server.g_global, dchan, weights,
                agg_cfg, transport, tmsgs=thetas if encode_theta else None,
                thetas=None if encode_theta else thetas,
                need_thetas=telemetry)
            step, thetas = aux["step"], aux["thetas"]
        else:
            deltas = dchan
            if transport is not None:
                # decode-then-aggregate: the mixing hook reads the decoded
                # cohort; the bytes are the messages' before decoding
                if ef_active:
                    dmsgs, deltas = dchan
                else:
                    dmsgs, deltas = dchan, transport.delta.decode(dchan)
                total = T.wire_bytes(dmsgs)
                if encode_theta:
                    total += T.wire_bytes(thetas)
                    thetas = transport.theta.decode(thetas)
            elif compress_fn is not None and thetas is not None:
                # legacy path: clients upload a compressed Theta; the
                # server aggregates its reconstruction (Table 6 trade-off)
                thetas = compress_fn(thetas)
            if spec.mixing is not None:
                weights = spec.mixing(deltas, thetas)
            params, new_theta, new_g, agg = aggregate(
                server.params, theta, server.g_global, deltas, thetas,
                weights, agg_cfg)
        if state_proto is not None:
            cstate = state_proto.server_update(cstate, ids, outs, n_clients)
        new_ctrl = update_controller(ctrl, agg["norm_drift"],
                                     agg["freshness"])
        metrics = dict(agg, loss=loss, beta=ctrl.beta)
        if telemetry:
            metrics["telemetry"] = obs_telemetry.collect(
                deltas=deltas, step=step, thetas=thetas, weights=weights,
                g_global=server.g_global, ctrl=ctrl, new_ctrl=new_ctrl,
                agg_metrics=agg)
        if total is not None:
            metrics.update(upload_bytes=total // s, upload_total_bytes=total,
                           cohort_size=s)
        new_server = advance_server(server, params, new_theta, new_g,
                                    geom=new_ctrl, aligned=spec.align)
        return new_server, cstate, metrics

    return driver


# ------------------------------------------------------- built-in algorithms

def _register_stateless_builtins():
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


_register_stateless_builtins()
