"""Decoder-only LM of the Llama architecture (SmolLM's family): RMSNorm
before attention and MLP, rotary positions, grouped-query attention with a
causal mask, SwiGLU, the embedding tied to the head; in plain PyTorch, with
the benchmark's weights for it and its next-token loss.

The configuration's keys are Hugging Face's ``LlamaConfig`` names.
Weights are stacked over the layers, one ``(layers, ...)`` tensor a weight,
as the program holds them.  Rotary embedding in the "rotate half" form
(Hugging Face's Llama): the two halves of a head dimension rotate
together.
"""
from __future__ import annotations

import math

import torch

from fedbench.reference.common import Precision


def _dims(cfg):
    d = cfg["hidden_size"]
    hd = d // cfg["num_attention_heads"]
    return d, hd, cfg["num_attention_heads"], cfg["num_key_value_heads"]


def weight_layout(cfg):
    """[(key path, shape, init)] in the program's tree order."""
    d, hd, nq, nkv = _dims(cfg)
    ff, n = cfg["intermediate_size"], cfg["num_hidden_layers"]
    if not cfg["tie_word_embeddings"]:
        raise ValueError("the reference ties the embedding to the head")
    g = ("blocks", 0)
    return [(("embed", "tok"), (cfg["vocab_size"], d), 0.02),
            (g + ("pre_norm", "scale"), (n, d), "ones"),
            (g + ("mixer", "wq"), (n, d, nq * hd), d ** -0.5),
            (g + ("mixer", "wk"), (n, d, nkv * hd), d ** -0.5),
            (g + ("mixer", "wv"), (n, d, nkv * hd), d ** -0.5),
            (g + ("mixer", "wo"), (n, nq * hd, d), (nq * hd) ** -0.5),
            (g + ("post_norm", "scale"), (n, d), "ones"),
            (g + ("mlp", "w_gate"), (n, d, ff), d ** -0.5),
            (g + ("mlp", "w_up"), (n, d, ff), d ** -0.5),
            (g + ("mlp", "w_down"), (n, ff, d), ff ** -0.5),
            (("final_norm", "scale"), (d,), "ones")]


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x: (..., T, D), positions 0..T-1."""
    s, dd = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, dd, 2, dtype=torch.float32,
                                  device=x.device) / dd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :dd // 2], x[..., dd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits(p, cfg, tokens, prec: Precision):
    """tokens (S, B, T) -> logits (S, B, T, vocab) for S clients at once;
    ``p`` a flat dict of per-client weights stacked to (S, ...)."""
    d, hd, nq, nkv = _dims(cfg)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    s_, b, t = tokens.shape
    tok = p["embed.tok"]
    x = tok[torch.arange(s_, device=tok.device)[:, None, None],
            tokens.long()]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    g = "blocks.0."
    for i in range(cfg["num_hidden_layers"]):
        def w(name):
            return p[g + name][:, i][:, None]

        def heads(a, n):
            return a.view(s_, b, t, n, hd).transpose(2, 3)
        h = _rms(x, w("pre_norm.scale")[:, :, None], eps)
        q = _rope(heads(prec.mm(h, w("mixer.wq")), nq), theta)
        k = _rope(heads(prec.mm(h, w("mixer.wk")), nkv), theta)
        v = heads(prec.mm(h, w("mixer.wv")), nkv)
        # query head j reads key/value head j // (nq / nkv)
        k = k.repeat_interleave(nq // nkv, dim=2)
        v = v.repeat_interleave(nq // nkv, dim=2)
        sc = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        att = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
        o = prec.mm(att, v).transpose(2, 3).reshape(s_, b, t, nq * hd)
        x = x + prec.mm(o, w("mixer.wo"))
        h = _rms(x, w("post_norm.scale")[:, :, None], eps)
        gate = torch.nn.functional.silu(prec.mm(h, w("mlp.w_gate")))
        x = x + prec.mm(gate * prec.mm(h, w("mlp.w_up")), w("mlp.w_down"))
    x = _rms(x, p["final_norm.scale"][:, None, None], eps)
    return prec.mm(x, tok.transpose(-1, -2)[:, None])


def loss(p, cfg, batch, prec: Precision):
    """(S,) mean next-token cross-entropy of each client's {"tokens",
    "labels"} (S, B, T), labels already shifted."""
    z = logits(p, cfg, batch["tokens"], prec)
    s_ = z.shape[0]
    return torch.nn.functional.cross_entropy(
        z.reshape(-1, z.shape[-1]), batch["labels"].reshape(-1).long(),
        reduction="none").view(s_, -1).mean(1)


def tokens_per_row(cfg) -> int:
    return cfg["data"]["seq_len"]
