"""Unified decoder: per-layer blocks stacked into groups (counterpart of
``repro/models/transformer.py``), for the ``attn``/``swa``/``local_attn``
blocks with a dense MLP.

Consecutive layers with the same signature (block kind, MoE-ness) are
stacked on a leading "layers" axis, one leaf ``(layers, ...)`` a weight,
as the reference stacks them for its ``lax.scan``.  The port runs a group
as a loop over the slices ``p_stack[i]``: the gradient of a stacked leaf
comes back as that one stacked leaf, so SOAP and Muon see the reference's
batched ``(layers, m, n)`` matrices, and their grouped launches count the
same.  ``remat`` (the reference's ``jax.checkpoint``) would map to
``torch.utils.checkpoint``, which does not compose with ``torch.func``'s
``vmap``/``grad`` of the client path, so it raises until the launch layer
needs it (ROADMAP queue 1 item 6).  MoE layers, MLA, and the ``mamba``/
``rglru`` blocks wait for items 3, 4 and 5.

Decode caches are stacked per group like the weights, one ``(layers,
...)`` leaf a buffer.  The reference's scan returns new stacked caches;
here layer ``i`` writes its new K/V into slice ``i`` of the group's
buffers in place, and ``backbone_forward`` returns the same tensors, so a
decode step copies no cache.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Initializer, apply_mlp, apply_norm, init_mlp, init_norm,
)
from repro_torch.utils.tree import tree_map

ATTN_KINDS = ("attn", "swa", "local_attn")


# the ROADMAP queue 1 item that brings each layer the port lacks
_ITEM = {"the MoE layer": 3, "multi-head latent attention (MLA)": 4,
         "the 'mamba' block": 5, "the 'rglru' block": 5}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item {_ITEM[what]})")


def _layer_is_moe(cfg: ModelConfig, layer: int) -> bool:
    return cfg.moe is not None and layer >= cfg.moe.first_dense_layers


def layer_signature(cfg: ModelConfig, layer: int):
    return (cfg.block_kind(layer), _layer_is_moe(cfg, layer))


def layer_groups(cfg: ModelConfig):
    """Consecutive same-signature runs: [(start, length, signature)]."""
    groups = []
    start = 0
    sig = layer_signature(cfg, 0)
    for layer in range(1, cfg.num_layers):
        s = layer_signature(cfg, layer)
        if s != sig:
            groups.append((start, layer - start, sig))
            start, sig = layer, s
    groups.append((start, cfg.num_layers - start, sig))
    return groups


# ---------------------------------------------------------------- init

def _check_kind(kind: str):
    if kind not in ATTN_KINDS:
        if kind in ("mamba", "rglru"):
            raise _not_ported(f"the {kind!r} block")
        raise ValueError(kind)


def init_layer(ini: Initializer, cfg: ModelConfig, kind: str, is_moe: bool):
    _check_kind(kind)
    if cfg.mla is not None:
        raise _not_ported("multi-head latent attention (MLA)")
    if is_moe:
        raise _not_ported("the MoE layer")
    p = {"pre_norm": init_norm(ini, cfg.d_model, cfg.norm_type),
         "mixer": attn.init_attention(ini, cfg)}
    if cfg.d_ff > 0:
        p["post_norm"] = init_norm(ini, cfg.d_model, cfg.norm_type)
        p["mlp"] = init_mlp(ini, cfg.d_model, cfg.d_ff, cfg.mlp_type)
    return p


def init_blocks(ini: Initializer, cfg: ModelConfig):
    """Returns list of stacked per-group params (leading axis = group size)."""
    blocks = []
    for start, length, (kind, is_moe) in layer_groups(cfg):
        layers = [init_layer(ini, cfg, kind, is_moe) for _ in range(length)]
        blocks.append(tree_map(lambda *xs: torch.stack(xs), *layers))
    return blocks


# ---------------------------------------------------------------- forward

def layer_forward(p, x, positions, cfg: ModelConfig, kind: str,
                  is_moe: bool, *, cache=None, cache_index=None):
    """One layer: ``(x, new_cache, aux)`` (aux is 0 without MoE; the
    cache, written in place, is ``cache`` itself)."""
    _check_kind(kind)
    if is_moe:
        raise _not_ported("the MoE layer")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(p["pre_norm"], x, cfg.norm_type)
    window = cfg.window if kind in ("swa", "local_attn") else 0
    out, new_cache = attn.attention_forward(
        p["mixer"], h, positions, cfg, window=window, cache=cache,
        cache_index=cache_index)
    x = x + out
    if "mlp" in p:
        h = apply_norm(p["post_norm"], x, cfg.norm_type)
        x = x + apply_mlp(p["mlp"], h, cfg.mlp_type)
    return x, new_cache, aux


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, ring: bool = False, device="cpu"):
    _check_kind(kind)
    if cfg.mla is not None:
        raise _not_ported("multi-head latent attention (MLA)")
    window = cfg.window if kind in ("swa", "local_attn") else 0
    return attn.init_attn_cache(cfg, batch, max_len, window, dtype,
                                ring=ring, device=device)


def init_group_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      ring: bool = False, device="cpu"):
    """One stacked cache tree per group (leading 'layers' axis)."""
    caches = []
    for start, length, (kind, is_moe) in layer_groups(cfg):
        one = init_layer_cache(cfg, kind, batch, max_len, dtype, ring=ring,
                               device=device)
        caches.append(tree_map(
            lambda a: a[None].repeat(length, *([1] * a.ndim)), one))
    return caches


def _kind_cache_axes(cfg: ModelConfig, kind: str):
    """Logical axes of one attention layer's cache (``init_layer_cache``)."""
    _check_kind(kind)
    if cfg.mla is not None:
        raise _not_ported("multi-head latent attention (MLA)")
    return {"k": ("batch", "seq", "kv_heads", "head_dim"),
            "v": ("batch", "seq", "kv_heads", "head_dim"),
            "pos": ("batch", "seq")}


def cache_axes(cfg: ModelConfig):
    """Logical axes per group-stacked cache (leading 'layers' axis)."""
    return [{k: ("layers",) + t for k, t in _kind_cache_axes(cfg,
                                                             kind).items()}
            for start, length, (kind, is_moe) in layer_groups(cfg)]


def backbone_forward(params, x, positions, cfg: ModelConfig, *, caches=None,
                     cache_index=None, remat: bool = False):
    """x: (B,S,D) embeddings.  Returns (hidden, new_caches, aux_sum);
    ``new_caches`` is ``caches`` (updated in place), None without."""
    if remat:
        raise NotImplementedError(
            "remat=True would need torch.utils.checkpoint, which does not "
            "compose with torch.func's vmap/grad of the client path; it "
            "comes with the launch layer (ROADMAP queue 1 item 6)")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (start, length, (kind, is_moe)) in enumerate(layer_groups(cfg)):
        p_stack = params["blocks"][gi]
        c_stack = caches[gi] if caches is not None else None
        for i in range(length):
            p_i = tree_map(lambda a: a[i], p_stack)
            c_i = (tree_map(lambda a: a[i], c_stack)
                   if c_stack is not None else None)
            x, _, aux = layer_forward(p_i, x, positions, cfg, kind, is_moe,
                                      cache=c_i, cache_index=cache_index)
            aux_total = aux_total + aux
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return x, caches, aux_total
