"""Public model API of the transformer LM: init and loss (counterpart of
``repro/models/model.py``).

Batch convention (all entries optional except labels for training):
  tokens : (B, S) int, or (B, S, C) for multi-codebook (MusicGen)
  embeds : (B, S, D) precomputed frontend embeddings (VLM / audio stubs)
  labels : same shape as tokens
  positions : (B, S) or (B, S, 3) for M-RoPE
  loss_mask : (B, S) weights of the next-token loss

The parameter tree keeps the reference's keys — ``embed/tok``
(``embed/head`` untied), ``blocks/<g>/{pre_norm,mixer,post_norm,mlp}/…``
stacked ``(layers, ...)`` per group, ``final_norm`` — so
``optim.api.is_hidden_matrix`` picks the same leaves for SOAP and Muon and
checkpoints are keyed by the same strings.  ``param_axes``, ``prefill``,
``decode_step`` and ``init_caches`` wait for ROADMAP queue 1 item 11.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Initializer, embed_tokens, init_embedding, init_norm, lm_logits,
)
from repro_torch.models.transformer import backbone_forward, init_blocks
from repro_torch.utils.tree import tree_leaves


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


def param_shapes(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no
    weights."""
    return _init(cfg, Initializer(None, dtype=cfg.torch_dtype))


def num_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape) if s.shape else 1
               for s in tree_leaves(param_shapes(cfg)))


# ---------------------------------------------------------------- forward

def _positions_for(cfg: ModelConfig, batch: int, seq: int, device):
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(batch, seq, 3)
    return pos


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False):
    """Returns (logits, None, aux_loss)."""
    if batch.get("embeds") is not None:
        x = batch["embeds"].to(cfg.torch_dtype)
    else:
        x = embed_tokens(params["embed"], batch["tokens"], cfg)
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_for(cfg, b, s, x.device)
    h, _, aux = backbone_forward(params, x, positions, cfg, remat=remat)
    return lm_logits(params["embed"], h, cfg), None, aux


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
