"""RG-LRU recurrent block (RecurrentGemma / Griffin family), counterpart
of ``repro/models/rglru.py``.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
with a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)); gates r, i are
linear in x.  Elementwise over the LRU width, so one inclusive scan over
the sequence suffices (no state dimension, no chunks): the log-depth
``ssm.scan_pairs``, in place of the reference's ``associative_scan``,
within an f32 bound of it.  GELU is ``jax.nn.gelu``'s tanh form.

The cache ``{"conv": (B, d_conv-1, w), "h": (B, w)}`` is written in
place and returned.  As in the reference, a forward over ``s > 1``
tokens (prefill) starts from h = 0 and a zero-padded conv whatever the
cache holds; only the conv tail is carried (see ``models.ssm``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Initializer, _gelu
from repro_torch.models.ssm import _causal_conv, scan_pairs


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def init_rglru(ini: Initializer, cfg: ModelConfig):
    r = cfg.rglru
    d = cfg.d_model
    w = _width(cfg)
    return {
        # x branch + gate branch
        "in_proj": ini.dense((d, 2 * w), ("embed", "ffn")),
        "conv_w": ini.dense((r.d_conv, w), ("conv", "ffn"), scale=0.5),
        "conv_b": ini.zeros((w,), ("ffn",)),
        "w_r": ini.dense((w, w), ("ffn", "ffn")),
        "b_r": ini.zeros((w,), ("ffn",)),
        "w_i": ini.dense((w, w), ("ffn", "ffn")),
        "b_i": ini.zeros((w,), ("ffn",)),
        # Lambda parameterized so a ~ U(0.9, 0.999) at init
        "lam": ini.constant(torch.linspace(-4.0, -9.0, w), ("ffn",)),
        "out_proj": ini.dense((w, d), ("ffn", "embed")),
    }


def _gates(p, xb, cfg: ModelConfig):
    r = torch.sigmoid(xb @ p["w_r"] + p["b_r"])
    i = torch.sigmoid(xb @ p["w_i"] + p["b_i"])
    log_a = -cfg.rglru.c * F.softplus(p["lam"]) * r.to(torch.float32)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i.to(torch.float32) * xb.to(torch.float32))
    return a, gated


def rglru_forward(p, x, cfg: ModelConfig, *, cache=None):
    """x: (B,S,D) -> (out, the cache written in place, or None)."""
    rcfg = cfg.rglru
    b, s, _ = x.shape
    xz = x @ p["in_proj"]
    xb, z = torch.chunk(xz, 2, dim=-1)

    if cache is None or s > 1:
        # training, or prefill (from an empty state, as the reference)
        conv = _causal_conv(xb, p["conv_w"]) + p["conv_b"]
        a, gated = _gates(p, conv, cfg)
        _, h = scan_pairs(a, gated, 1)
        if cache is not None:
            tail = torch.cat([cache["conv"], xb.to(cache["conv"].dtype)],
                             dim=1)
            cache["conv"].copy_(tail[:, -(rcfg.d_conv - 1):])
            cache["h"].copy_(h[:, -1])
        y = h.to(x.dtype)
    else:
        window = torch.cat([cache["conv"], xb.to(cache["conv"].dtype)],
                           dim=1)
        conv = (torch.einsum("bkd,kd->bd", window, p["conv_w"])
                + p["conv_b"])[:, None]
        a, gated = _gates(p, conv, cfg)
        h = a[:, 0] * cache["h"] + gated[:, 0]
        y = h.to(x.dtype)[:, None]
        cache["conv"].copy_(window[:, 1:])
        cache["h"].copy_(h)

    y = y * _gelu(z)
    return y @ p["out_proj"], cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    w = _width(cfg)
    return {
        "conv": torch.zeros((batch, cfg.rglru.d_conv - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
