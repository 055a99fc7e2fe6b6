"""ViT classifier (DeiT layout: a class token, learned positions, pre-norm
blocks) in plain PyTorch: the benchmark's weights for it and its loss.

The configuration's keys are Hugging Face's ViT/DeiT names.  As the
program's model runs it (the paper's repository): no bias on the query,
key, value and output projections, LayerNorm eps 1e-6, GELU in its tanh
form, the class token's final state to the head.
"""
from __future__ import annotations

import math

import torch

from fedbench.reference.common import Precision


def weight_layout(cfg):
    """[(key path, shape, init)] in the program's tree order; ``init`` is a
    standard deviation, or "zeros"/"ones"."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    p, c = cfg["patch_size"], cfg["num_channels"]
    n_patches = (cfg["image_size"] // p) ** 2
    out = [(("patch_embed",), (p * p * c, d), (p * p * c) ** -0.5),
           (("pos_embed",), (n_patches + 1, d), 0.02),
           (("cls",), (1, 1, d), "zeros")]
    for i in range(cfg["num_hidden_layers"]):
        b = ("blocks", i)
        out += [(b + ("ln1_scale",), (d,), "ones"),
                (b + ("ln1_bias",), (d,), "zeros"),
                (b + ("wqkv",), (d, 3 * d), d ** -0.5),
                (b + ("wo",), (d, d), d ** -0.5),
                (b + ("ln2_scale",), (d,), "ones"),
                (b + ("ln2_bias",), (d,), "zeros"),
                (b + ("w1",), (d, ff), d ** -0.5),
                (b + ("b1",), (ff,), "zeros"),
                (b + ("w2",), (ff, d), ff ** -0.5),
                (b + ("b2",), (d,), "zeros")]
    out += [(("final_ln_scale",), (d,), "ones"),
            (("final_ln_bias",), (d,), "zeros"),
            (("head", "w"), (d, cfg["num_labels"]), d ** -0.5),
            (("head", "b"), (cfg["num_labels"],), "zeros")]
    return out


def _ln(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _v(t):
    """A per-client vector (S, d) against activations (S, B, T, d)."""
    return t[:, None, None, :]


def logits(p, cfg, images, prec: Precision):
    """images (S, B, H, W, C) -> logits (S, B, classes) for S clients at
    once; ``p`` a flat dict of per-client weights stacked to (S, ...)."""
    patch, heads = cfg["patch_size"], cfg["num_attention_heads"]
    eps = cfg["layer_norm_eps"]
    s_, b, hh, ww, c = images.shape
    x = images.reshape(s_, b, hh // patch, patch, ww // patch, patch, c)
    x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(s_, b, -1, patch * patch * c)
    x = prec.mm(x, p["patch_embed"][:, None])
    d = x.shape[-1]
    x = torch.cat([p["cls"].expand(s_, b, 1, d), x], dim=2) \
        + p["pos_embed"][:, None]
    t, hd = x.shape[2], d // heads
    for i in range(cfg["num_hidden_layers"]):
        k = f"blocks.{i}."

        def w(name):
            return p[k + name][:, None]
        h = _ln(x, _v(p[k + "ln1_scale"]), _v(p[k + "ln1_bias"]), eps)
        q, kk, v = prec.mm(h, w("wqkv")).split(d, dim=-1)
        q, kk, v = (a.reshape(s_, b, t, heads, hd).transpose(2, 3)
                    for a in (q, kk, v))
        att = torch.softmax(prec.mm(q, kk.transpose(-1, -2))
                            / math.sqrt(hd), dim=-1)
        o = prec.mm(att, v).transpose(2, 3).reshape(s_, b, t, d)
        x = x + prec.mm(o, w("wo"))
        h = _ln(x, _v(p[k + "ln2_scale"]), _v(p[k + "ln2_bias"]), eps)
        h = torch.nn.functional.gelu(
            prec.mm(h, w("w1")) + _v(p[k + "b1"]), approximate="tanh")
        x = x + prec.mm(h, w("w2")) + _v(p[k + "b2"])
    x = _ln(x, _v(p["final_ln_scale"]), _v(p["final_ln_bias"]), eps)
    return prec.mm(x[:, :, 0], p["head.w"]) + p["head.b"][:, None]


def loss(p, cfg, batch, prec: Precision):
    """(S,) mean cross-entropy of each client's batch {"x": images (S, B,
    ...), "y": labels (S, B)}."""
    z = logits(p, cfg, batch["x"], prec)
    s_, b = z.shape[:2]
    return torch.nn.functional.cross_entropy(
        z.reshape(s_ * b, -1), batch["y"].reshape(-1).long(),
        reduction="none").view(s_, b).mean(1)


def tokens_per_row(cfg) -> int:
    return (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
