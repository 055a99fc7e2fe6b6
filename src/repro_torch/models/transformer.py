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
needs it; ``mamba``/``rglru`` blocks and MoE layers wait for ROADMAP
queue 1 item 11, as do the decode caches.
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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item 11)")


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
    if kind not in ATTN_KINDS:
        if kind in ("mamba", "rglru"):
            raise _not_ported(f"the {kind!r} block")
        raise ValueError(kind)
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
                  is_moe: bool):
    """One layer: ``(x, None, aux)`` (no cache; aux is 0 without MoE)."""
    if kind not in ATTN_KINDS:
        raise _not_ported(f"the {kind!r} block")
    if is_moe:
        raise _not_ported("the MoE layer")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(p["pre_norm"], x, cfg.norm_type)
    window = cfg.window if kind in ("swa", "local_attn") else 0
    x = x + attn.attention_forward(p["mixer"], h, positions, cfg,
                                   window=window)
    if "mlp" in p:
        h = apply_norm(p["post_norm"], x, cfg.norm_type)
        x = x + apply_mlp(p["mlp"], h, cfg.mlp_type)
    return x, None, aux


def backbone_forward(params, x, positions, cfg: ModelConfig, *,
                     remat: bool = False):
    """x: (B,S,D) embeddings.  Returns (hidden, None, aux_sum)."""
    if remat:
        raise NotImplementedError(
            "remat=True would need torch.utils.checkpoint, which does not "
            "compose with torch.func's vmap/grad of the client path; it "
            "comes with the launch layer (ROADMAP queue 1 item 11)")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (start, length, (kind, is_moe)) in enumerate(layer_groups(cfg)):
        p_stack = params["blocks"][gi]
        for i in range(length):
            p_i = tree_map(lambda a: a[i], p_stack)
            x, _, aux = layer_forward(p_i, x, positions, cfg, kind, is_moe)
            aux_total = aux_total + aux
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return x, None, aux_total
