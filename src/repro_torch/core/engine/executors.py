"""Cohort executors: how one round's S clients map onto the device —
counterpart of ``repro/core/engine/executors.py``.

``make_cohort_executor`` returns ``run(fn, *stacked_args)``, which applies
a per-client function over the leading (S,) client axis of every argument
and returns stacked outputs.  Backends:

  vmap       one batched program (``torch.func.vmap``) for the whole
             cohort — the default;
  chunked    ``vmap`` over consecutive slices of ``chunk_size`` clients,
             outputs joined along the client axis, so peak activation
             memory scales with the chunk.  PyTorch compiles no program
             per shape, so the tail slice runs at its own length: no
             padding, unlike the reference's ``lax.map`` over padded
             chunks;
  shard_map  the client axis split over a mesh's client axes, ``vmap``
             on each shard;
  sharded    ``shard_map`` with the chunked body inside each shard.

The port's meshes have one device, the run's own (``mesh=None``): the
reference's divisibility check holds trivially there, and the sharded
backends reduce to ``vmap`` and ``chunked``.  A mesh of several devices
(``torch.distributed`` ``DeviceMesh``) waits for ROADMAP queue 1 item 7
and raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

BACKENDS = ("vmap", "shard_map", "chunked", "sharded")


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    backend: str = "vmap"
    chunk_size: int = 8                   # chunked/sharded: clients a slice
    mesh: Optional[Any] = None            # None: the run's one device
    client_axes: tuple = ("pod", "data")  # mesh axes to shard clients over

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown executor backend {self.backend!r} "
                f"(want one of {BACKENDS})")
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")


def _leading_dim(args) -> int:
    return tree_leaves(args)[0].shape[0]


def _chunked_run(fn, chunk_size: int, *args):
    """``vmap`` over cohort slices of ``chunk_size``, joined."""
    s = _leading_dim(args)
    if s <= chunk_size:
        return torch.func.vmap(fn)(*args)
    outs = [torch.func.vmap(fn)(*tree_map(lambda x: x[a:a + chunk_size],
                                          args))
            for a in range(0, s, chunk_size)]
    return tree_map(lambda *xs: torch.cat(xs), *outs)


def _mesh_extent(cfg: ExecutorConfig) -> int:
    """Devices the client axis spreads over: 1 for the run's own device."""
    if cfg.mesh is None:
        return 1
    size = cfg.mesh.size() if callable(getattr(cfg.mesh, "size", None)) \
        else int(cfg.mesh)
    if size != 1:
        raise NotImplementedError(
            f"a {size}-device mesh for the {cfg.backend!r} executor is not "
            "ported (ROADMAP queue 1 item 7: torch.distributed DeviceMesh "
            "sharding); mesh=None runs on the run's own device")
    return 1


def make_cohort_executor(cfg: ExecutorConfig | None = None):
    cfg = cfg or ExecutorConfig()

    def vmapped(fn, *args):
        return torch.func.vmap(fn)(*args)

    def chunked(fn, *args):
        return _chunked_run(fn, cfg.chunk_size, *args)

    if cfg.backend == "vmap":
        return vmapped
    if cfg.backend == "chunked":
        return chunked
    n = _mesh_extent(cfg)                 # an unported mesh raises here
    body = vmapped if cfg.backend == "shard_map" else chunked

    def sharded(fn, *args):
        s = _leading_dim(args)
        if s % n != 0:
            raise ValueError(
                f"cohort size {s} not divisible by the client-axis "
                f"extent {n} (mesh axes {cfg.client_axes}) — pad the cohort "
                f"or use the 'chunked' executor")
        return body(fn, *args)
    return sharded
