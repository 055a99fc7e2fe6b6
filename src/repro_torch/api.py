"""Top-level public API: the algorithm and scenario registries and
``build_experiment`` — counterpart of ``repro/api.py`` (the sync and
buffered-asynchronous runtimes).

    from repro_torch.api import build_experiment

    exp = build_experiment("fedpac_soap", scenario="cifar_like_cnn",
                           rounds=30)              # on the GPU
    history = exp.run()

    exp = build_experiment("fedpac_soap", scenario="cifar_like_cnn",
                           device="cpu")           # plain PyTorch path

    exp = build_experiment("fedpac_soap", scenario="cifar_like_cnn",
                           async_cfg=AsyncConfig(buffer_size=5))  # async

    spec = dataclasses.replace(                    # a 10^6-id population,
        resolve_scenario("cifar_like_cnn"),        # pipelined
        partition=PartitionSpec("stream_dirichlet", alpha=0.3))
    exp = build_experiment("fedpac_sophia", scenario=spec,
                           population_size=1_000_000, cohort_size=16,
                           pipeline=True, pipeline_chunk=4)

Every registered algorithm builds the same way: ``fedavg``, ``fedcm``,
``scaffold``, ``{local,fedpac,align_only,correct_only}_{sgd,adamw,muon,
soap,sophia}``, ``fedpm_{adamw,sophia,muon,soap}``, and the
``<registered>_light`` variant of each (rank-r SVD Theta upload);
scenarios ``cifar_like_{cnn,vit}[_dir0.05|_shard|_iid]``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.core.algorithms import (  # noqa: F401  (re-exported API)
    AlgorithmSpec, ClientStateSpec, DuplicateAlgorithmError,
    UnknownAlgorithmError, register, registered, resolve,
)
from repro_torch.fed.async_runtime import (  # noqa: F401
    AsyncConfig, AsyncFederatedExperiment, LatencyModel,
)
from repro_torch.fed.base import FedExperiment
from repro_torch.fed.rounds import FedConfig, FederatedExperiment
from repro_torch.scenarios import (  # noqa: F401  (re-exported API)
    DuplicateScenarioError, PartitionSpec, Scenario, ScenarioSpec,
    UnknownScenarioError, materialize,
)
from repro_torch.scenarios import (  # noqa: F401
    register as register_scenario,
    registered as registered_scenarios,
    resolve as resolve_scenario,
)
from repro_torch.utils.hw import resolve_device

__all__ = [
    "AlgorithmSpec", "AsyncConfig", "AsyncFederatedExperiment",
    "ClientStateSpec", "DuplicateAlgorithmError",
    "DuplicateScenarioError", "FedConfig", "FedExperiment", "LatencyModel",
    "PartitionSpec",
    "Scenario", "ScenarioSpec", "UnknownAlgorithmError",
    "UnknownScenarioError", "build_experiment", "materialize", "register",
    "register_scenario", "registered", "registered_scenarios", "resolve",
    "resolve_scenario",
]


def build_experiment(
    algorithm: Union[str, AlgorithmSpec],
    *,
    scenario: Optional[Union[str, ScenarioSpec, Scenario]] = None,
    params=None,
    loss_fn: Optional[Callable] = None,
    client_batch_fn: Optional[Callable] = None,
    eval_fn: Optional[Callable] = None,
    opt_kwargs: Optional[dict] = None,
    fed: Optional[FedConfig] = None,
    async_cfg: Optional[AsyncConfig] = None,
    traffic=None,
    population=None,
    **fed_overrides,
) -> FedExperiment:
    """Build the runtime the config names for ``algorithm`` on ``scenario``
    (or on an explicit problem bundle) with keyword configuration.

    algorithm: registered name or an ``AlgorithmSpec``.
    scenario: registered name, a ``ScenarioSpec``, or a pre-materialized
      ``Scenario`` (which must match the config's ``n_clients`` and
      device).  Names/specs materialize with the config's seed on its
      device; when the caller names no cohort size, the scenario's own
      ``n_clients`` becomes the config's.
    fed / fed_overrides: a base ``FedConfig`` and field overrides, e.g.
      ``rounds=30, device="cpu"``.  The device defaults to ``"cuda"``.
    async_cfg: the async runtime's knobs; implies ``runtime="async"`` when
      no config and no ``runtime`` override was passed — an explicit one
      is authoritative, and a sync one with ``async_cfg`` is an error.
    population: optional ``fed.population.ClientPopulation`` carrying a
      weighted or availability sampler; it must agree with the config's
      population knobs (``population_size``/``cohort_size``).  With
      ``population_size`` set and no object, the uniform streaming
      population is built from the config.  In population mode a scenario
      is materialized over the id space (``population_size`` clients):
      use a lazy partition kind (``stream_dirichlet``) at 10^5+ ids.
    traffic: the continuous-traffic runtime is not ported; passing it
      raises NotImplementedError.
    """
    if traffic is not None:
        raise NotImplementedError(
            "the continuous-traffic runtime is not ported (ROADMAP queue 1 "
            "item 9: fed/traffic)")
    spec = resolve(algorithm)
    changes = dict(fed_overrides, algorithm=spec.name)
    if async_cfg is not None and fed is None and \
            "runtime" not in fed_overrides:
        changes["runtime"] = "async"

    if scenario is not None:
        explicit = [n for n, v in [("params", params), ("loss_fn", loss_fn),
                                   ("client_batch_fn", client_batch_fn),
                                   ("eval_fn", eval_fn)] if v is not None]
        if explicit:
            raise ValueError(
                "pass either scenario= or the explicit problem bundle, not "
                f"both (got scenario plus {', '.join(explicit)})")
        premade = isinstance(scenario, Scenario)
        scn_n_clients = (scenario.n_clients if premade
                         else resolve_scenario(scenario).n_clients)
        if fed is None and "n_clients" not in changes:
            changes["n_clients"] = scn_n_clients

    cfg = (FedConfig(**changes) if fed is None
           else dataclasses.replace(fed, **changes))
    # population mode: the scenario's client axis is the abstract id space
    id_space = (cfg.population_size if cfg.population_active
                else cfg.n_clients)
    scn = None
    if scenario is not None:
        if premade:
            if scenario.n_clients != id_space:
                raise ValueError(
                    f"pre-materialized scenario {scenario.spec.name!r} was "
                    f"built for n_clients={scenario.n_clients} but the "
                    f"config wants {id_space}")
            if torch.device(scenario.device) != resolve_device(cfg.device):
                raise ValueError(
                    f"pre-materialized scenario {scenario.spec.name!r} lives "
                    f"on {scenario.device} but the config runs on "
                    f"{cfg.device}")
            scn = scenario
        else:
            scn = materialize(scenario, seed=cfg.seed,
                              n_clients=id_space, device=cfg.device)
        params, loss_fn, client_batch_fn, eval_fn = scn.problem()
    elif params is None or loss_fn is None or client_batch_fn is None:
        raise TypeError(
            "build_experiment needs either scenario= or the explicit "
            "params/loss_fn/client_batch_fn bundle")

    if cfg.runtime == "sync":
        if async_cfg is not None:
            raise ValueError(
                "async_cfg given but the config says runtime='sync' — set "
                "runtime='async' (or drop the async_cfg)")
        exp = FederatedExperiment(cfg, params, loss_fn, client_batch_fn,
                                  eval_fn, opt_kwargs, spec=spec,
                                  population=population)
    else:
        exp = AsyncFederatedExperiment(cfg, params, loss_fn, client_batch_fn,
                                       eval_fn, opt_kwargs,
                                       async_cfg=async_cfg, spec=spec,
                                       population=population)
    exp.scenario = scn
    return exp
