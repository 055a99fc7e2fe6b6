"""Public model API of the transformer LM: init, loss, prefill and decode
(counterpart of ``repro/models/model.py``).

Batch convention (all entries optional except labels for training):
  tokens : (B, S) int, or (B, S, C) for multi-codebook (MusicGen)
  embeds : (B, S, D) precomputed frontend embeddings (VLM / audio stubs)
  labels : same shape as tokens
  positions : (B, S) or (B, S, 3) for M-RoPE
  loss_mask : (B, S) weights of the next-token loss

The parameter tree keeps the reference's keys — ``embed/tok``
(``embed/head`` untied), ``blocks/<g>/{pre_norm,mixer,post_norm,mlp|moe}/…``
stacked ``(layers, ...)`` per group, ``final_norm`` — so
``optim.api.is_hidden_matrix`` picks the same leaves for SOAP and Muon and
checkpoints are keyed by the same strings.  ``init_boxed`` returns the
weights as ``layers.Box``es with their logical sharding axes, and
``param_axes`` the axes tree alone, built on the ``meta`` device.

Serving: ``prefill`` fills fresh caches with the prompt, ``decode_step``
takes one token a sequence and writes into the caches it is given, in
place (see ``models.transformer``).  Positions default to ``arange(S)``
offset by ``cache_index``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Initializer, axes_of, constrain, embed_tokens, init_embedding,
    init_norm, lm_logits,
)
from repro_torch.models.transformer import (
    backbone_forward, init_blocks, init_group_caches,
)
from repro_torch.utils.tree import tree_leaves, tree_map


# ---------------------------------------------------------------- init

def _init(cfg: ModelConfig, ini: Initializer):
    return {
        "embed": init_embedding(ini, cfg),
        "blocks": init_blocks(ini, cfg),
        "final_norm": init_norm(ini, cfg.d_model, cfg.norm_type),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cpu"):
    """Weights drawn from ``gen`` on the host in the reference's order,
    then placed on ``device`` in ``cfg.dtype``."""
    return _init(cfg, Initializer(gen, dtype=cfg.torch_dtype,
                                  device=device))


def init_boxed(cfg: ModelConfig, gen: torch.Generator, device="cpu"):
    """``init_params``'s weights, each a ``Box`` with its logical axes."""
    return _init(cfg, Initializer(gen, dtype=cfg.torch_dtype,
                                  device=device, boxed=True))


def param_axes(cfg: ModelConfig):
    """The logical axes of every weight, as a params-shaped tree of
    tuples (shapes only: no memory allocated)."""
    return axes_of(_init(cfg, Initializer(None, dtype=cfg.torch_dtype,
                                          boxed=True)))


def param_shapes(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no
    weights."""
    return _init(cfg, Initializer(None, dtype=cfg.torch_dtype))


def num_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape) if s.shape else 1
               for s in tree_leaves(param_shapes(cfg)))


# ---------------------------------------------------------------- forward

def _positions_for(cfg: ModelConfig, batch: int, seq: int, device,
                   offset=0):
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + offset
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(batch, seq, 3)
    return pos


def forward(params, batch, cfg: ModelConfig, *, caches=None,
            cache_index=None, remat: bool = False):
    """Returns (logits, new_caches, aux_loss); ``new_caches`` is
    ``caches``, written in place, or None without caches."""
    if batch.get("embeds") is not None:
        src = batch["embeds"]
        x = src.to(cfg.torch_dtype)
    else:
        src = batch["tokens"]
        x = embed_tokens(params["embed"], src, cfg)
    # DTensor inputs (the dry-run): the activations start in the batch's
    # layout (its batch and sequence dims)
    x = constrain(x, getattr(src, "placements", None))
    b, s = x.shape[:2]
    if cache_index is not None:
        cache_index = int(cache_index)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_for(cfg, b, s, x.device,
                                   offset=cache_index or 0)
    h, new_caches, aux = backbone_forward(
        params, x, positions, cfg, caches=caches, cache_index=cache_index,
        remat=remat)
    return lm_logits(params["embed"], h, cfg), new_caches, aux


def cross_entropy(logits, labels, loss_mask: Optional[torch.Tensor] = None):
    """Mean next-token cross-entropy in f32 (masked mean under
    ``loss_mask``)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if loss_mask is not None:
        nll = nll * loss_mask
        denom = torch.clamp(torch.sum(loss_mask), min=1.0)
        return torch.sum(nll) / denom
    return torch.mean(nll)


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False):
    """Mean next-token cross-entropy (+ MoE aux). Labels are pre-shifted."""
    logits, _, aux = forward(params, batch, cfg, remat=remat)
    return cross_entropy(logits, batch["labels"],
                         batch.get("loss_mask")) + aux


# ---------------------------------------------------------------- serving

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                ring: bool = False, device="cpu"):
    """Empty caches stacked per group (leading 'layers' axis), in
    ``cfg.dtype`` on ``device``; ``ring=True`` bounds a windowed layer's
    buffer to its window (long decode)."""
    return init_group_caches(cfg, batch, max_len, cfg.torch_dtype,
                             ring=ring, device=device)


def prefill(params, batch, cfg: ModelConfig, max_len: int):
    """Run the prompt through the model into fresh linear caches of
    ``max_len`` slots (written from index 0), on the params' device.
    Returns (last_token_logits, caches)."""
    if batch.get("embeds") is not None:
        b = batch["embeds"].shape[0]
    else:
        b = batch["tokens"].shape[0]
    ref = params["final_norm"]["scale"]
    caches = init_caches(cfg, b, max_len, device=ref.device)
    if hasattr(ref, "placements"):
        # DTensor params (the dry-run's meshes): replicated caches, so
        # that each layer's write is a DTensor op
        from torch.distributed.tensor import DTensor, Replicate
        mesh = ref.device_mesh
        caches = tree_map(lambda c: DTensor.from_local(
            c, mesh, [Replicate()] * mesh.ndim, run_check=False), caches)
    logits, caches, _ = forward(params, batch, cfg, caches=caches,
                                cache_index=0)
    return logits[:, -1], caches


def decode_step(params, tokens, caches, index, cfg: ModelConfig):
    """One decode step.  tokens: (B, 1[, C]); index: the position of the
    new token (a host int or a 0-d tensor).  Writes the new K/V into
    ``caches`` in place and returns (logits (B, [C,] V), caches)."""
    logits, caches, _ = forward(params, {"tokens": tokens}, cfg,
                                caches=caches, cache_index=index)
    return logits[:, -1], caches
