"""The scenario registry: ``register`` / ``resolve`` / ``materialize`` —
counterpart of ``repro/scenarios/registry.py``.  Source families register
with ``register_source(name, fn)``, ``fn(spec, seed, n_clients, device)
-> Scenario``.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

from repro_torch.scenarios.spec import (
    DuplicateScenarioError, Scenario, ScenarioSpec, UnknownScenarioError,
)
from repro_torch.utils.hw import resolve_device

_REGISTRY: dict = {}
_SOURCES: dict = {}


def register_source(name: str, fn: Callable, *,
                    overwrite: bool = False) -> Callable:
    if name in _SOURCES and not overwrite:
        raise DuplicateScenarioError(
            f"scenario source {name!r} is already registered "
            "(pass overwrite=True to replace it)")
    _SOURCES[name] = fn
    return fn


def resolve_source(spec: ScenarioSpec) -> Callable:
    if callable(spec.source):
        return spec.source
    if spec.source not in _SOURCES:
        raise UnknownScenarioError(
            f"scenario {spec.name!r} names unknown source {spec.source!r} "
            f"(registered sources: {', '.join(sorted(_SOURCES))})")
    return _SOURCES[spec.source]


def register(spec: ScenarioSpec, *, overwrite: bool = False) -> ScenarioSpec:
    if not isinstance(spec, ScenarioSpec):
        raise TypeError(f"register wants a ScenarioSpec, got {type(spec)}")
    if isinstance(spec.source, str) and spec.source not in _SOURCES:
        raise ValueError(
            f"spec {spec.name!r} names unknown source {spec.source!r} "
            f"(registered sources: {', '.join(sorted(_SOURCES))})")
    if spec.name in _REGISTRY and not overwrite:
        raise DuplicateScenarioError(
            f"scenario {spec.name!r} is already registered "
            "(pass overwrite=True to replace it)")
    _REGISTRY[spec.name] = spec
    return spec


def registered() -> tuple:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> ScenarioSpec:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise UnknownScenarioError(
        f"unknown scenario {name!r}: registered scenarios are "
        f"{', '.join(registered())}")


def resolve(spec_or_name: Union[str, ScenarioSpec]) -> ScenarioSpec:
    if isinstance(spec_or_name, ScenarioSpec):
        return spec_or_name
    return get(str(spec_or_name))


def materialize(scenario: Union[str, ScenarioSpec], seed: int = 0,
                n_clients: Optional[int] = None,
                device="cuda") -> Scenario:
    """Turn a declarative spec into the concrete problem bundle, its params
    and eval data on ``device``."""
    spec = resolve(scenario)
    n = spec.n_clients if n_clients is None else int(n_clients)
    if n < 1:
        raise ValueError(f"n_clients must be >= 1, got {n}")
    scn = resolve_source(spec)(spec, int(seed), n, resolve_device(device))
    if not isinstance(scn, Scenario):
        raise TypeError(
            f"source for scenario {spec.name!r} returned {type(scn)}; "
            "materializers must return a scenarios.Scenario")
    return scn
