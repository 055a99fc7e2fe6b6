"""The dry-run's stand-ins for inputs and states, with their shardings
(counterpart of ``repro/launch/specs.py``).

Nothing here allocates memory: each stand-in is a DTensor on the mesh
whose local shard is a fake tensor (under the active ``FakeTensorMode``)
or, without one, a ``meta`` tensor, of the shard's shape.  Shapes come
from ``models.param_shapes``, the optimizer's ``init`` run on ``meta``
tensors and ``models.init_caches`` on ``meta``; placements from
``models.param_axes``/``transformer.cache_axes`` through ``resolve_spec``
and, for trees without logical axes, ``greedy_spec``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import cache_axes
from repro_torch.sharding.partitioning import (
    TRAIN_RULES, greedy_spec, resolve_spec, spec_to_placements,
)
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def batch_spec(mesh, batch: int) -> tuple:
    return resolve_spec((batch,), ("batch",), mesh, TRAIN_RULES)


def _sds(shape, dtype, mesh, spec):
    """A DTensor of global ``shape`` laid out by ``spec`` on ``mesh``,
    its local shard fake (or ``meta``): no memory."""
    from torch._guards import detect_fake_mode
    from torch.distributed.tensor import DTensor
    placements = spec_to_placements(spec, mesh)
    local = list(shape)
    for j, pl in enumerate(placements):
        if pl.is_shard():
            local[pl.dim] //= mesh.size(j)
    mode = detect_fake_mode()
    device = mesh.device_type if mode is not None else "meta"
    t = torch.empty(local, dtype=dtype, device=device)
    return DTensor.from_local(
        t, mesh, placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def token_inputs(cfg: ModelConfig, shape: InputShape, mesh, *, rules,
                 with_labels: bool):
    """Stand-ins for one step's data batch."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    tok_shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    tok_spec = resolve_spec(tok_shape, ("batch", "seq") + (("codebook",)
                            if cfg.num_codebooks > 1 else ()), mesh, rules)
    batch = {"tokens": _sds(tok_shape, torch.int32, mesh, tok_spec)}
    if cfg.accepts_embeds and shape.kind != "decode":
        # frontend stub: precomputed patch/frame embeddings
        espec = resolve_spec((b, s, cfg.d_model), ("batch", "seq", None),
                             mesh, rules)
        batch["embeds"] = _sds((b, s, cfg.d_model), cfg.torch_dtype, mesh,
                               espec)
        batch["tokens"] = None
    if with_labels:
        batch["labels"] = _sds(tok_shape, torch.int32, mesh, tok_spec)
    return batch


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def param_specs(cfg: ModelConfig, mesh, rules):
    def one(t, ax):
        return _sds(tuple(t.shape), t.dtype, mesh,
                    resolve_spec(tuple(t.shape), ax, mesh, rules))
    return tree_map(one, M.param_shapes(cfg), M.param_axes(cfg),
                    is_leaf=_is_tensor)


def _meta(tree):
    return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                          device="meta"), tree)


def opt_state_specs(opt, params_sds, mesh):
    """The optimizer's ``init`` on ``meta`` params, every leaf
    greedy-sharded."""
    return like_tree_specs(opt.init(_meta(params_sds)), mesh)


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh, rules,
                ring: bool):
    caches = M.init_caches(cfg, shape.global_batch, shape.seq_len,
                           ring=ring, device="meta")

    def one(t, ax):
        return _sds(tuple(t.shape), t.dtype, mesh,
                    resolve_spec(tuple(t.shape), ax, mesh, rules))
    return tree_map(one, caches, cache_axes(cfg), is_leaf=_is_tensor)


def like_tree_specs(tree_sds, mesh):
    """Greedy shardings for an arbitrary tree of tensors (g_global,
    Theta, optimizer states)."""
    return tree_map(lambda t: _sds(tuple(t.shape), t.dtype, mesh,
                                   greedy_spec(tuple(t.shape), mesh)),
                    tree_sds)


def shardings_of(tree):
    """The DTensor placements of every leaf."""
    return tree_map(lambda x: x.placements, tree)
