"""Declarative scenario data model — counterpart of
``repro/scenarios/spec.py``.

A frozen ``ScenarioSpec`` declares data source x partition x model x
batching; ``materialize`` (``scenarios.registry``) turns it into the
concrete ``Scenario`` bundle that ``repro_torch.api.build_experiment``
consumes.  ``PartitionSpec`` is the heterogeneity control: the eager
``dirichlet``, ``shard``, ``quantity`` and ``iid`` kinds, and the lazy
``stream_dirichlet`` kind for population-scale id spaces.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Union

import numpy as np

from repro_torch.data.partition import (
    ClientIndexMap, dirichlet_partition, iid_partition, quantity_partition,
    shard_partition, stream_dirichlet_map,
)


class UnknownScenarioError(ValueError):
    """Name resolves to no registered ``ScenarioSpec``."""


class DuplicateScenarioError(ValueError):
    """``register`` called twice for the same scenario name."""


PARTITION_KINDS = ("dirichlet", "shard", "quantity", "iid",
                   "stream_dirichlet")

#: kinds whose split is derived per client on demand (``build`` returns a
#: ``ClientIndexMap``): the only kinds usable at population scale
LAZY_PARTITION_KINDS = ("stream_dirichlet",)


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """How samples are split across clients: ``kind`` one of
    ``PARTITION_KINDS``; ``alpha`` the Dirichlet concentration for
    ``dirichlet`` (label skew), ``quantity`` (size skew) and
    ``stream_dirichlet`` (each client's label mixture);
    ``shards_per_client`` drives the pathological ``shard`` split and
    ``samples_per_client`` sizes a streamed client's view of the pool."""
    kind: str = "dirichlet"
    alpha: float = 0.1
    shards_per_client: int = 2
    min_size: int = 2
    samples_per_client: int = 64

    def __post_init__(self):
        if self.kind not in PARTITION_KINDS:
            raise ValueError(
                f"unknown partition kind {self.kind!r} "
                f"(want one of {PARTITION_KINDS})")
        if self.kind in ("dirichlet", "quantity", "stream_dirichlet") and \
                self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")
        if self.shards_per_client < 1:
            raise ValueError(
                f"shards_per_client must be >= 1, got "
                f"{self.shards_per_client}")
        if self.samples_per_client < 1:
            raise ValueError(
                f"samples_per_client must be >= 1, got "
                f"{self.samples_per_client}")

    @property
    def lazy(self) -> bool:
        """Whether ``build`` yields a lazy map rather than an eager list."""
        return self.kind in LAZY_PARTITION_KINDS

    def build(self, labels: Optional[np.ndarray], n_samples: int,
              n_clients: int, seed: int):
        """A list of ``n_clients`` index arrays, or for a lazy kind a
        ``ClientIndexMap``; both index as ``parts[cid]``."""
        if self.kind == "iid":
            return iid_partition(n_samples, n_clients, seed=seed)
        if self.kind == "quantity":
            return quantity_partition(n_samples, n_clients, self.alpha,
                                      seed=seed, min_size=self.min_size)
        if labels is None:
            raise ValueError(
                f"partition kind {self.kind!r} needs labels, but this "
                "scenario's data source provides none")
        if self.kind == "dirichlet":
            return dirichlet_partition(labels, n_clients, self.alpha,
                                       seed=seed, min_size=self.min_size)
        if self.kind == "stream_dirichlet":
            return stream_dirichlet_map(
                labels, n_clients, self.alpha,
                samples_per_client=self.samples_per_client, seed=seed)
        return shard_partition(labels, n_clients,
                               shards_per_client=self.shards_per_client,
                               seed=seed)

    def tag(self) -> str:
        """Short name for sweep rows / derived-variant names."""
        if self.kind == "dirichlet":
            return f"dir{self.alpha:g}"
        if self.kind == "quantity":
            return f"qty{self.alpha:g}"
        if self.kind == "shard":
            return f"shard{self.shards_per_client}"
        if self.kind == "stream_dirichlet":
            return f"sdir{self.alpha:g}"
        return "iid"


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One federated task, declaratively.

    source: data-source family key (``"synth_image"``) or a callable
      materializer ``(spec, seed, n_clients, device) -> Scenario``.
    model: model-factory key of the source family (``"cnn"`` | ``"vit"``).
    source_kwargs / model_kwargs: family-specific knobs over its defaults.
    """
    name: str
    source: Union[str, Callable] = "synth_image"
    partition: PartitionSpec = PartitionSpec()
    model: str = "cnn"
    n_clients: int = 10
    batch_size: int = 16
    source_kwargs: Mapping = dataclasses.field(default_factory=dict)
    model_kwargs: Mapping = dataclasses.field(default_factory=dict)
    description: str = ""

    def __post_init__(self):
        if not self.name:
            raise ValueError("a ScenarioSpec needs a non-empty name")
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {self.n_clients}")
        if self.batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {self.batch_size}")

    def variant(self, suffix: str, **changes) -> "ScenarioSpec":
        """Renamed derived spec with field overrides."""
        return dataclasses.replace(self, name=f"{self.name}_{suffix}",
                                   **changes)


def check_source_kwargs(spec: "ScenarioSpec", defaults: Mapping) -> dict:
    """Defaults overlaid with the spec's knobs; unknown keys are an error."""
    unknown = set(spec.source_kwargs) - set(defaults)
    if unknown:
        raise ValueError(
            f"scenario {spec.name!r}: unknown source_kwargs "
            f"{sorted(unknown)} (this source understands "
            f"{sorted(defaults)})")
    kw = dict(defaults)
    kw.update(spec.source_kwargs)
    return kw


@dataclasses.dataclass
class Scenario:
    """A materialized scenario: the concrete problem the runtime consumes.
    ``problem()`` returns ``(params, loss_fn, client_batch_fn, eval_fn)``;
    ``device`` is where params and eval data live (a required keyword:
    no default puts a GPU run's data on the CPU).  ``partitions`` is a
    list for eager kinds, a lazy ``ClientIndexMap`` for streamed ones."""
    spec: ScenarioSpec
    seed: int
    n_clients: int
    params: Any
    loss_fn: Callable
    client_batch_fn: Callable
    eval_fn: Optional[Callable]
    device: Any = dataclasses.field(kw_only=True)
    partitions: Optional[Union[list, ClientIndexMap]] = None
    partition_stats: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    def problem(self):
        return (self.params, self.loss_fn, self.client_batch_fn,
                self.eval_fn)
