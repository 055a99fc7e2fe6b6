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

``mesh=None`` (or a one-rank mesh) is the run's own device: the
reference's divisibility check holds trivially, and the sharded backends
reduce to ``vmap`` and ``chunked``.  On a ``torch.distributed``
``DeviceMesh`` whose client axes (``sharding.client_axis_spec``) span
``n`` ranks, every rank runs the same call: it takes its ``S/n`` clients
(the slice at its pod-major index along those axes), runs the body on
them, and all-gathers each stacked output over the client axes, so every
rank holds the cohort's outputs in client order, as the reference's
``shard_map`` hands them to the engine.  A cohort that ``n`` does not
divide raises.
"""
from __future__ import annotations

import dataclasses
import math
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


def _client_group(cfg: ExecutorConfig):
    """(n, index, group): the ranks the client axis spreads over, this
    rank's pod-major index among them, and their process group; (1, 0,
    None) for the run's own device."""
    mesh = cfg.mesh
    if mesh is None or (isinstance(mesh, int) and mesh == 1):
        return 1, 0, None
    if not hasattr(mesh, "mesh_dim_names"):
        raise ValueError(
            f"the {cfg.backend!r} executor takes a torch.distributed "
            f"DeviceMesh or None, got {mesh!r}")
    from repro_torch.sharding.partitioning import client_axis_spec
    axes, _ = client_axis_spec(mesh, preferred=cfg.client_axes)
    n = math.prod(mesh[a].size() for a in axes)
    if n == 1:
        return 1, 0, None
    sub = mesh[axes] if len(axes) > 1 else mesh[axes[0]]
    if len(axes) > 1:
        sub = sub._flatten()
    return n, sub.get_local_rank(), sub.get_group()


def _gather_clients(tree, n: int, group):
    """Each leaf's (S/n, ...) rows from every rank of ``group``, joined
    in rank order along the client axis."""
    import torch.distributed as dist

    def one(x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)
    return tree_map(one, tree)


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
    n, index, group = _client_group(cfg)
    body = vmapped if cfg.backend == "shard_map" else chunked

    def sharded(fn, *args):
        s = _leading_dim(args)
        if s % n != 0:
            raise ValueError(
                f"cohort size {s} not divisible by the client-axis "
                f"extent {n} (mesh axes {cfg.client_axes}) — pad the cohort "
                f"or use the 'chunked' executor")
        if n == 1:
            return body(fn, *args)
        w = s // n
        mine = tree_map(lambda x: x[index * w:(index + 1) * w], args)
        return _gather_clients(body(fn, *mine), n, group)
    return sharded
