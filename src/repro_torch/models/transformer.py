"""Unified decoder: per-layer blocks stacked into groups (counterpart of
``repro/models/transformer.py``): attention (GQA, windowed, or MLA),
Mamba and RG-LRU mixers, each followed by a dense or MoE MLP (none after
a Mamba block).

Consecutive layers with the same signature (block kind, MoE-ness) are
stacked on a leading "layers" axis, one leaf ``(layers, ...)`` a weight,
as the reference stacks them for its ``lax.scan``.  The port runs a group
as a loop over the slices ``p_stack[i]``: the gradient of a stacked leaf
comes back as that one stacked leaf, so SOAP and Muon see the reference's
batched ``(layers, m, n)`` matrices (and ``(layers, E, m, n)`` expert
stacks), and their grouped launches count the same.  ``remat`` (the
reference's ``jax.checkpoint`` around each layer) runs each layer under
the non-reentrant ``torch.utils.checkpoint``: the backward keeps only
the layer's input and recomputes the layer, and a second derivative
(Sophia's Hessian-vector product by double backward) recomputes it
again.  It works under plain autograd, the single-client train step's
(``launch.steps``); ``torch.func``'s ``grad``/``vjp`` do not take the
saved-tensor hooks that the checkpoint rests on, so under a ``torch.func``
transform (the cohort path of ``core.client``) ``remat=True`` raises.

Decode caches are stacked per group like the weights, one ``(layers,
...)`` leaf a buffer: K/V (or MLA's latents) for attention, the O(1)
conv and recurrent states for Mamba and RG-LRU.  The reference's scan
returns new stacked caches; here layer ``i`` writes into slice ``i`` of
the group's buffers in place, and ``backbone_forward`` returns the same
tensors, so a decode step copies no cache.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Box, Initializer, apply_mlp, apply_norm, constrain, init_mlp, init_norm,
    unbox,
)
from repro_torch.utils.tree import tree_map

ATTN_KINDS = ("attn", "swa", "local_attn")


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

def init_layer(ini: Initializer, cfg: ModelConfig, kind: str, is_moe: bool):
    p = {"pre_norm": init_norm(ini, cfg.d_model, cfg.norm_type)}
    if kind in ATTN_KINDS:
        if cfg.mla is not None:
            p["mixer"] = attn.init_mla(ini, cfg)
        else:
            p["mixer"] = attn.init_attention(ini, cfg)
    elif kind == "mamba":
        p["mixer"] = ssm_lib.init_mamba(ini, cfg)
    elif kind == "rglru":
        p["mixer"] = rglru_lib.init_rglru(ini, cfg)
    else:
        raise ValueError(kind)

    if kind != "mamba" and (cfg.d_ff > 0 or is_moe):
        p["post_norm"] = init_norm(ini, cfg.d_model, cfg.norm_type)
        if is_moe:
            p["moe"] = moe_lib.init_moe(ini, cfg)
        else:
            p["mlp"] = init_mlp(ini, cfg.d_model, cfg.d_ff, cfg.mlp_type)
    return p


def init_blocks(ini: Initializer, cfg: ModelConfig):
    """Returns list of stacked per-group params (leading axis = group size);
    boxed weights get the leading ``"layers"`` axis."""
    blocks = []
    for start, length, (kind, is_moe) in layer_groups(cfg):
        # one (length, ...) buffer a leaf, filled layer by layer in the
        # draw order: a group never holds its layers twice
        first = init_layer(ini, cfg, kind, is_moe)
        stack = tree_map(lambda a: a.new_empty((length, *a.shape)),
                         unbox(first))
        for i in range(length):
            layer = first if i == 0 else init_layer(ini, cfg, kind, is_moe)
            tree_map(lambda buf, a: buf[i].copy_(a), stack, unbox(layer))
        if ini.boxed:
            stack = tree_map(lambda b, v: Box(v, ("layers",) + b.axes),
                             first, stack,
                             is_leaf=lambda x: isinstance(x, Box))
        blocks.append(stack)
    return blocks


# ---------------------------------------------------------------- forward

def layer_forward(p, x, positions, cfg: ModelConfig, kind: str,
                  is_moe: bool, *, cache=None, cache_index=None):
    """One layer: ``(x, new_cache, aux)`` (aux is the MoE router's
    load-balance loss, else 0; the cache, written in place, is ``cache``
    itself)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # a DTensor x (the dry-run): the norms' outputs and the residual
    # branches, and their gradients, are held in x's layout
    layout = getattr(x, "placements", None)
    h = constrain(apply_norm(p["pre_norm"], x, cfg.norm_type), layout)
    if kind in ATTN_KINDS:
        if cfg.mla is not None:
            out, new_cache = attn.mla_forward(
                p["mixer"], h, positions, cfg, cache=cache,
                cache_index=cache_index)
        else:
            window = cfg.window if kind in ("swa", "local_attn") else 0
            out, new_cache = attn.attention_forward(
                p["mixer"], h, positions, cfg, window=window, cache=cache,
                cache_index=cache_index)
    elif kind == "mamba":
        out, new_cache = ssm_lib.mamba_forward(p["mixer"], h, cfg,
                                               cache=cache)
    elif kind == "rglru":
        out, new_cache = rglru_lib.rglru_forward(p["mixer"], h, cfg,
                                                 cache=cache)
    else:
        raise ValueError(kind)
    x = x + constrain(out, layout)

    if "moe" in p:
        h = constrain(apply_norm(p["post_norm"], x, cfg.norm_type), layout)
        out, aux = moe_lib.moe_forward(p["moe"], h, cfg)
        x = x + constrain(out, layout)
    elif "mlp" in p:
        h = constrain(apply_norm(p["post_norm"], x, cfg.norm_type), layout)
        x = x + constrain(apply_mlp(p["mlp"], h, cfg.mlp_type), layout)
    return x, new_cache, aux


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, ring: bool = False, device="cpu"):
    if kind in ATTN_KINDS:
        if cfg.mla is not None:
            return attn.init_mla_cache(cfg, batch, max_len, dtype,
                                       device=device)
        window = cfg.window if kind in ("swa", "local_attn") else 0
        return attn.init_attn_cache(cfg, batch, max_len, window, dtype,
                                    ring=ring, device=device)
    if kind == "mamba":
        return ssm_lib.init_mamba_cache(cfg, batch, dtype, device=device)
    if kind == "rglru":
        return rglru_lib.init_rglru_cache(cfg, batch, dtype, device=device)
    raise ValueError(kind)


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
    """Logical axes of one layer's cache (``init_layer_cache``)."""
    if kind in ATTN_KINDS:
        if cfg.mla is not None:
            return {"c_kv": ("batch", "seq", "kv_lora"),
                    "k_rope": ("batch", "seq", None),
                    "pos": ("batch", "seq")}
        return {"k": ("batch", "seq", "kv_heads", "head_dim"),
                "v": ("batch", "seq", "kv_heads", "head_dim"),
                "pos": ("batch", "seq")}
    if kind == "mamba":
        return {"conv": ("batch", None, "ffn"), "ssm": ("batch", "ffn", None)}
    if kind == "rglru":
        return {"conv": ("batch", None, "ffn"), "h": ("batch", "ffn")}
    raise ValueError(kind)


def cache_axes(cfg: ModelConfig):
    """Logical axes per group-stacked cache (leading 'layers' axis)."""
    return [{k: ("layers",) + t for k, t in _kind_cache_axes(cfg,
                                                             kind).items()}
            for start, length, (kind, is_moe) in layer_groups(cfg)]


def backbone_forward(params, x, positions, cfg: ModelConfig, *, caches=None,
                     cache_index=None, remat: bool = False):
    """x: (B,S,D) embeddings.  Returns (hidden, new_caches, aux_sum);
    ``new_caches`` is ``caches`` (updated in place), None without."""
    remat = remat and caches is None
    if remat and torch._C._functorch.peek_interpreter_stack() is not None:
        raise NotImplementedError(
            "remat=True runs each layer under torch.utils.checkpoint, whose "
            "saved-tensor hooks torch.func's grad/vjp do not support: use "
            "remat with plain autograd (launch.steps.make_train_step), not "
            "under a torch.func transform (the cohort path of "
            "core.client.client_round)")
    # a DTensor x (the dry-run's meshes): every layer's input, and its
    # gradient, is held in x's layout at entry (the batch's), as the
    # reference's XLA propagation keeps it
    layout = getattr(x, "placements", None)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (start, length, (kind, is_moe)) in enumerate(layer_groups(cfg)):
        p_stack = params["blocks"][gi]
        c_stack = caches[gi] if caches is not None else None
        for i in range(length):
            p_i = tree_map(lambda a: a[i], p_stack)
            x = constrain(x, layout)
            if remat:
                x, aux = checkpoint(
                    lambda h, p=p_i, k=kind, m=is_moe: layer_forward(
                        p, h, positions, cfg, k, m)[::2],
                    x, use_reentrant=False)
                aux_total = aux_total + aux
                continue
            c_i = (tree_map(lambda a: a[i], c_stack)
                   if c_stack is not None else None)
            x, _, aux = layer_forward(p_i, x, positions, cfg, kind, is_moe,
                                      cache=c_i, cache_index=cache_index)
            aux_total = aux_total + aux
    x = constrain(apply_norm(params["final_norm"], x, cfg.norm_type),
                  layout)
    return x, caches, aux_total
