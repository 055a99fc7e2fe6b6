"""Core layers of the transformer LM: norms, MLPs, embeddings and the
head (counterpart of ``repro/models/layers.py``), and the ``Initializer``
that takes the place of ``repro/models/param.py``.

The ``Initializer`` draws every weight from one ``torch.Generator``, in
the reference's order and with its distributions and scales (fan-in
scaled normal for dense weights, N(0, 0.02) for embeddings, ones and
zeros for norms and biases, ``constant`` for Mamba's and RG-LRU's fixed
inits), not its random bits: parity runs carry the reference's weights
across (``repro_torch.convert``).  A host generator draws on the host and
copies to ``device`` (every CPU path and test); a CUDA generator draws on
the card, so that the billions of weights of a full-width table are not
drawn by one host thread.  With
``gen=None`` it builds shapes only (tensors on the ``meta`` device), the
counterpart of the reference's ``jax.eval_shape`` over its init.  Logical
sharding axes are not kept: they belong to the mesh layer (ROADMAP
queue 1 item 7).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


class Initializer:
    """Weights in the reference's draw order from one generator (on the
    generator's device, then placed on ``device``); shapes only when
    ``gen`` is None."""

    def __init__(self, gen: Optional[torch.Generator], dtype=torch.float32,
                 device="cpu"):
        self.gen = gen
        self.dtype = dtype
        self.device = torch.device("meta") if gen is None else device

    def _normal(self, shape, std):
        if self.gen is None:
            return torch.empty(shape, dtype=self.dtype, device="meta")
        v = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.gen.device) * std
        return v.to(device=self.device, dtype=self.dtype)

    def dense(self, shape, scale=None):
        fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
        if len(shape) == 3:  # (expert, d_in, d_out)
            fan_in = shape[1]
        return self._normal(shape, scale if scale is not None
                            else fan_in ** -0.5)

    def embedding(self, shape, scale=1.0):
        return self._normal(shape, scale)

    def zeros(self, shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, shape):
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def constant(self, value):
        """``value`` (a tensor or array-like) as a weight; its shape only
        when building shapes."""
        value = torch.as_tensor(value)
        if self.gen is None:
            return torch.empty(value.shape, dtype=self.dtype, device="meta")
        return value.to(device=self.device, dtype=self.dtype)


# ---------------------------------------------------------------- norms

def init_norm(ini: Initializer, d: int, kind: str):
    if kind == "rms":
        return {"scale": ini.ones((d,))}
    return {"scale": ini.ones((d,)), "bias": ini.zeros((d,))}


def apply_norm(p, x, kind: str, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind == "rms":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * p["scale"].to(torch.float32)).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------- mlp

def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_mlp(ini: Initializer, d: int, d_ff: int, mlp_type: str):
    if mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": ini.dense((d, d_ff)),
            "w_up": ini.dense((d, d_ff)),
            "w_down": ini.dense((d_ff, d)),
        }
    if mlp_type == "gelu":
        return {
            "w_up": ini.dense((d, d_ff)),
            "b_up": ini.zeros((d_ff,)),
            "w_down": ini.dense((d_ff, d)),
            "b_down": ini.zeros((d,)),
        }
    raise ValueError(mlp_type)


def apply_mlp(p, x, mlp_type: str):
    if mlp_type in ("swiglu", "geglu"):
        act = F.silu if mlp_type == "swiglu" else _gelu
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    h = _gelu(x @ p["w_up"] + p["b_up"])
    return h @ p["w_down"] + p["b_down"]


# ---------------------------------------------------------------- embeddings / head

def init_embedding(ini: Initializer, cfg: ModelConfig):
    p = {}
    if cfg.num_codebooks > 1:
        p["tok"] = ini.embedding(
            (cfg.num_codebooks, cfg.vocab_size, cfg.d_model), scale=0.02)
    else:
        p["tok"] = ini.embedding((cfg.vocab_size, cfg.d_model), scale=0.02)
    if not cfg.tie_embeddings:
        if cfg.num_codebooks > 1:
            p["head"] = ini.dense(
                (cfg.num_codebooks, cfg.d_model, cfg.vocab_size))
        else:
            p["head"] = ini.dense((cfg.d_model, cfg.vocab_size))
    return p


def embed_tokens(p, tokens, cfg: ModelConfig):
    """tokens: (B, S) int or (B, S, C) for multi-codebook models."""
    if cfg.num_codebooks > 1:
        # sum of the codebooks' embeddings (MusicGen-style)
        return sum(p["tok"][c][tokens[..., c]]
                   for c in range(cfg.num_codebooks))
    return p["tok"][tokens]


def lm_logits(p, x, cfg: ModelConfig):
    if cfg.num_codebooks > 1:
        if cfg.tie_embeddings:
            # (B,S,D) x (C,V,D) -> (B,S,C,V)
            return torch.einsum("bsd,cvd->bscv", x, p["tok"])
        return torch.einsum("bsd,cdv->bscv", x, p["head"])
    if cfg.tie_embeddings:
        return x @ p["tok"].transpose(-1, -2)
    return x @ p["head"]
