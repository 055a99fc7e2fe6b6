"""Top-level public API: the algorithm and scenario registries and the one
experiment builder — counterpart of ``repro/api.py`` (sync runtime only).

    from repro_torch.api import build_experiment

    exp = build_experiment("fedpac_soap", scenario="cifar_like_cnn",
                           rounds=30)              # on the GPU
    history = exp.run()

    exp = build_experiment("fedpac_soap", scenario="cifar_like_cnn",
                           device="cpu")           # plain PyTorch path

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
    "AlgorithmSpec", "ClientStateSpec", "DuplicateAlgorithmError",
    "DuplicateScenarioError", "FedConfig", "FedExperiment", "PartitionSpec",
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
    **fed_overrides,
) -> FedExperiment:
    """Build the sync runtime for ``algorithm`` on ``scenario`` (or on an
    explicit problem bundle) with keyword configuration.

    algorithm: registered name or an ``AlgorithmSpec``.
    scenario: registered name, a ``ScenarioSpec``, or a pre-materialized
      ``Scenario`` (which must match the config's ``n_clients`` and
      device).  Names/specs materialize with the config's seed on its
      device; when the caller names no cohort size, the scenario's own
      ``n_clients`` becomes the config's.
    fed / fed_overrides: a base ``FedConfig`` and field overrides, e.g.
      ``rounds=30, device="cpu"``.  The device defaults to ``"cuda"``.
    """
    spec = resolve(algorithm)
    changes = dict(fed_overrides, algorithm=spec.name)

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
    scn = None
    if scenario is not None:
        if premade:
            if scenario.n_clients != cfg.n_clients:
                raise ValueError(
                    f"pre-materialized scenario {scenario.spec.name!r} was "
                    f"built for n_clients={scenario.n_clients} but the "
                    f"config wants {cfg.n_clients}")
            if torch.device(scenario.device) != resolve_device(cfg.device):
                raise ValueError(
                    f"pre-materialized scenario {scenario.spec.name!r} lives "
                    f"on {scenario.device} but the config runs on "
                    f"{cfg.device}")
            scn = scenario
        else:
            scn = materialize(scenario, seed=cfg.seed,
                              n_clients=cfg.n_clients, device=cfg.device)
        params, loss_fn, client_batch_fn, eval_fn = scn.problem()
    elif params is None or loss_fn is None or client_batch_fn is None:
        raise TypeError(
            "build_experiment needs either scenario= or the explicit "
            "params/loss_fn/client_batch_fn bundle")

    exp = FederatedExperiment(cfg, params, loss_fn, client_batch_fn, eval_fn,
                              opt_kwargs, spec=spec)
    exp.scenario = scn
    return exp
