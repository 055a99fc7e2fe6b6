"""Logical-axis sharding with divisibility-safe resolution (counterpart of
``repro/sharding/partitioning.py``), for ``torch.distributed`` meshes.

Models name every parameter dimension with a *logical* axis ("embed",
"ffn", "heads", ...; ``models.param_axes``).  A rule set maps logical
names to mesh axes.  ``resolve_spec`` turns (shape, logical axes) into a
spec that is valid for the given mesh:

* a mesh axis is only assigned to a dim it divides evenly;
* a mesh axis is used at most once per spec;
* anything else is replicated.

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry a
tensor dim: a mesh-axis name, a tuple of names (that dim split over
several axes, the first outermost), or None (replicated), trailing Nones
stripped.  The resolvers read only the mesh's axis names and sizes
(``mesh_sizes``): a ``DeviceMesh`` or any object with a ``shape`` mapping
of names to sizes.  ``spec_to_placements`` turns a spec into the DTensor
placements of a ``DeviceMesh``: mesh dim ``j`` shards tensor dim ``d``
when the spec names ``j``'s axis at ``d``, else replicates.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class LogicalAxisRules:
    """Map logical axis name -> preferred mesh axes (in priority order)."""

    rules: Mapping[str, tuple[str, ...]]

    def mesh_axes_for(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        return tuple(self.rules.get(logical, ()))


# Training: FSDP over "data" (first big dim of 2-D weights) x TP over
# "model"; batch over pod+data.  Cross-pod weights replicated (pod = a
# federated site).
TRAIN_RULES = LogicalAxisRules(
    {
        "batch": ("pod", "data"),
        "client": ("pod", "data"),
        "embed": ("data",),
        "ffn": ("model",),
        "qkv": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),
        "vocab": ("model",),
        "expert": (),
        "seq": (),
        "kv_lora": ("model",),
        "conv": (),
        "state": (),
        "codebook": (),
    }
)


# Serving with FSDP weights: 2-D shard the weights over (data, model) too
# — trades per-layer all-gathers for fitting very large models at decode.
def _serve_fsdp_rules():
    base = dict(SERVE_RULES.rules)
    base["embed"] = ("data",)
    return LogicalAxisRules(base)


# Serving: weights stationary, tensor-parallel only; batch over pod+data.
# KV caches shard batch and (when the small GQA head counts do not divide
# the model axis) the head_dim instead — always-divisible 128-multiples.
SERVE_RULES = LogicalAxisRules(
    {
        "batch": ("pod", "data"),
        "client": ("pod", "data"),
        "embed": (),
        "ffn": ("model",),
        "qkv": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),
        "vocab": ("model",),
        "expert": (),
        "seq": (),
        "kv_lora": ("model",),
        "conv": (),
        "state": (),
        "codebook": (),
    }
)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (its ``mesh_dim_names``), or
    of any object whose ``shape`` maps names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _strip(dims: list) -> tuple:
    while dims and dims[-1] is None:
        dims.pop()
    return tuple(dims)


def resolve_spec(
    shape: Sequence[int],
    logical_axes: Sequence[str | None],
    mesh,
    rules: LogicalAxisRules,
) -> tuple:
    """A valid spec for ``shape`` under ``mesh``."""
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                         f"logical axes {tuple(logical_axes)}")
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    dims: list = []
    for dim, logical in zip(shape, logical_axes):
        assigned: list[str] = []
        factor = 1
        for axis in rules.mesh_axes_for(logical):
            if axis not in sizes or axis in used:
                continue
            size = sizes[axis]
            if dim % (factor * size) != 0:
                continue
            assigned.append(axis)
            used.add(axis)
            factor *= size
        if not assigned:
            dims.append(None)
        elif len(assigned) == 1:
            dims.append(assigned[0])
        else:
            dims.append(tuple(assigned))
    return _strip(dims)


SERVE_FSDP_RULES = _serve_fsdp_rules()


def client_axis_spec(mesh, preferred: Sequence[str] = ("pod", "data")):
    """Mesh axes (and leading-dim spec) for the cohort client axis: the
    subset of ``preferred`` present in ``mesh``, in order."""
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in preferred if a in sizes)
    if not axes:
        raise ValueError(
            f"mesh {sizes} has none of the client axes {tuple(preferred)}")
    return axes, (axes if len(axes) > 1 else axes[0],)


def greedy_spec(shape: Sequence[int], mesh,
                axes_order: tuple[str, ...] = ("data", "model")) -> tuple:
    """Divisibility-safe spec for tensors without logical axes (optimizer
    states: Kronecker factors, eigenbases, rotated moments): dim -2 <-
    data, dim -1 <- model where they divide evenly; leading dims (expert
    and stacking dims) stay replicated."""
    if len(shape) < 2:
        return ()
    sizes = mesh_sizes(mesh)
    dims: list = [None] * len(shape)
    targets = [len(shape) - 2, len(shape) - 1]
    for axis, d in zip(axes_order, targets):
        if axis in sizes and shape[d] % sizes[axis] == 0 and shape[d] > 1:
            dims[d] = axis
    return _strip(dims)


def spec_to_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements, one a mesh dim, for ``spec`` on the
    ``DeviceMesh`` ``mesh``.  A tensor dim split over several mesh axes
    keeps the spec's order (the first outermost), which DTensor's
    left-to-right sharding gives only when the axes come in mesh order:
    another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec entry {axes} for dim {d} is not in the "
                             f"mesh's axis order {tuple(names)}")
        for j in where:
            placements[j] = Shard(d)
    return tuple(placements)


def _is_shape(x):
    return isinstance(x, tuple) and all(isinstance(d, int) for d in x)


def _is_axes(x):
    return x is None or (isinstance(x, tuple) and all(
        isinstance(d, (str, type(None))) for d in x))


def logical_to_sharding(tree_shapes, tree_axes, mesh,
                        rules: LogicalAxisRules):
    """Trees of shapes + logical axes -> tree of DTensor placements on
    ``mesh``."""
    return tree_map(
        lambda shape, axes: spec_to_placements(
            resolve_spec(shape, axes, mesh, rules), mesh),
        tree_shapes, tree_axes, is_leaf=_is_shape)


def shard_params_spec(params_shapes, params_axes, mesh,
                      rules: LogicalAxisRules):
    """Tree of specs for a params tree: ``params_shapes`` leaves have a
    ``shape`` (tensors, ``meta`` tensors); ``params_axes`` leaves are
    tuples of logical names (len == rank)."""
    return tree_map(
        lambda axes, t: resolve_spec(tuple(t.shape), axes, mesh, rules),
        params_axes, params_shapes, is_leaf=_is_axes)
