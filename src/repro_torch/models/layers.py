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
counterpart of the reference's ``jax.eval_shape`` over its init.

Every weight is named with its logical sharding axes, one a dimension
(``("embed", "ffn")``), as the reference's ``param.Box`` names them.  With
``boxed=True`` each weight comes back as a ``Box(value, axes)``;
``unbox``/``axes_of`` split such a tree into the plain params and the
axes tree that ``repro_torch.sharding`` reads.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.utils.tree import tree_map


class Box:
    """A weight with its per-dimension logical axis names."""

    __slots__ = ("value", "axes")

    def __init__(self, value, axes):
        self.value = value
        self.axes = tuple(axes)

    def __repr__(self):
        return f"Box({tuple(self.value.shape)}, axes={self.axes})"


def _is_box(x):
    return isinstance(x, Box)


def unbox(tree):
    """The plain params (a tree without boxes passes through)."""
    return tree_map(lambda b: b.value if _is_box(b) else b, tree,
                    is_leaf=_is_box)


def axes_of(tree):
    return tree_map(lambda b: b.axes, tree, is_leaf=_is_box)


class _Layout(torch.autograd.Function):
    """A DTensor and its gradient both put in ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def constrain(x, placements):
    """``x`` (and, in the backward, its gradient) in DTensor
    ``placements``: the port's ``with_sharding_constraint`` for the
    dry-run's meshes, where DTensor's own propagation drifts into
    layouts its view and matmul rules do not take.  A plain tensor, or
    ``placements=None``, passes through."""
    if placements is None or not hasattr(x, "placements"):
        return x
    return _Layout.apply(x, tuple(placements))


class Initializer:
    """Weights in the reference's draw order from one generator (on the
    generator's device, then placed on ``device``); shapes only when
    ``gen`` is None; each a ``Box`` with its axes when ``boxed``."""

    def __init__(self, gen: Optional[torch.Generator], dtype=torch.float32,
                 device="cpu", boxed: bool = False):
        self.gen = gen
        self.dtype = dtype
        self.device = torch.device("meta") if gen is None else device
        self.boxed = boxed

    def _out(self, value, axes):
        if len(axes) != value.ndim:
            raise ValueError(f"axes {axes} for a weight of shape "
                             f"{tuple(value.shape)}")
        return Box(value, axes) if self.boxed else value

    def _normal(self, shape, std):
        if self.gen is None:
            return torch.empty(shape, dtype=self.dtype, device="meta")
        v = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.gen.device) * std
        return v.to(device=self.device, dtype=self.dtype)

    def dense(self, shape, axes, scale=None):
        fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
        if len(shape) == 3:  # (expert, d_in, d_out)
            fan_in = shape[1]
        return self._out(self._normal(shape, scale if scale is not None
                                      else fan_in ** -0.5), axes)

    def embedding(self, shape, axes, scale=1.0):
        return self._out(self._normal(shape, scale), axes)

    def zeros(self, shape, axes):
        return self._out(torch.zeros(shape, dtype=self.dtype,
                                     device=self.device), axes)

    def ones(self, shape, axes):
        return self._out(torch.ones(shape, dtype=self.dtype,
                                    device=self.device), axes)

    def constant(self, value, axes):
        """``value`` (a tensor or array-like) as a weight; its shape only
        when building shapes."""
        value = torch.as_tensor(value)
        if self.gen is None:
            return self._out(torch.empty(value.shape, dtype=self.dtype,
                                         device="meta"), axes)
        return self._out(value.to(device=self.device, dtype=self.dtype),
                         axes)


# ---------------------------------------------------------------- norms

def init_norm(ini: Initializer, d: int, kind: str):
    if kind == "rms":
        return {"scale": ini.ones((d,), ("embed",))}
    return {"scale": ini.ones((d,), ("embed",)),
            "bias": ini.zeros((d,), ("embed",))}


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
            "w_gate": ini.dense((d, d_ff), ("embed", "ffn")),
            "w_up": ini.dense((d, d_ff), ("embed", "ffn")),
            "w_down": ini.dense((d_ff, d), ("ffn", "embed")),
        }
    if mlp_type == "gelu":
        return {
            "w_up": ini.dense((d, d_ff), ("embed", "ffn")),
            "b_up": ini.zeros((d_ff,), ("ffn",)),
            "w_down": ini.dense((d_ff, d), ("ffn", "embed")),
            "b_down": ini.zeros((d,), ("embed",)),
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
            (cfg.num_codebooks, cfg.vocab_size, cfg.d_model),
            ("codebook", "vocab", "embed"), scale=0.02)
    else:
        p["tok"] = ini.embedding((cfg.vocab_size, cfg.d_model),
                                 ("vocab", "embed"), scale=0.02)
    if not cfg.tie_embeddings:
        if cfg.num_codebooks > 1:
            p["head"] = ini.dense(
                (cfg.num_codebooks, cfg.d_model, cfg.vocab_size),
                ("codebook", "embed", "vocab"))
        else:
            p["head"] = ini.dense((cfg.d_model, cfg.vocab_size),
                                  ("embed", "vocab"))
    return p


def _lookup(table, ids):
    """``table[ids]``; a DTensor table (the dry-run) through
    ``F.embedding``, whose backward DTensor shards where that of an
    indexing op it may not."""
    if hasattr(table, "placements"):
        return F.embedding(ids, table)
    return table[ids]


def embed_tokens(p, tokens, cfg: ModelConfig):
    """tokens: (B, S) int or (B, S, C) for multi-codebook models."""
    if cfg.num_codebooks > 1:
        # sum of the codebooks' embeddings (MusicGen-style)
        return sum(_lookup(p["tok"][c], tokens[..., c])
                   for c in range(cfg.num_codebooks))
    return _lookup(p["tok"], tokens)


def lm_logits(p, x, cfg: ModelConfig):
    if cfg.num_codebooks > 1:
        if cfg.tie_embeddings:
            # (B,S,D) x (C,V,D) -> (B,S,C,V)
            return torch.einsum("bsd,cvd->bscv", x, p["tok"])
        return torch.einsum("bsd,cdv->bscv", x, p["head"])
    if cfg.tie_embeddings:
        return x @ p["tok"].transpose(-1, -2)
    return x @ p["head"]
