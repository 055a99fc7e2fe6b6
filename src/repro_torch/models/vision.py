"""Vision models of the paper's own experiments, in PyTorch: a ResNet-style
CNN (GroupNorm) and a ViT classifier — counterparts of
``repro/models/vision.py``.

Parameters are plain nested dicts (ViT ``blocks`` a list) in the JAX
layouts — NHWC images, HWIO conv kernels, ``x @ W`` dense weights — so
weights carry across with ``repro_torch.convert`` and the apply functions
run unchanged under ``torch.func.vmap`` over a stacked client axis.

Numerics follow the reference: JAX "SAME" padding (asymmetric for strided
convs: padded explicitly, since ``F.conv2d(padding="same")`` refuses
stride 2), 8-group GroupNorm with population variance and eps 1e-5,
LayerNorm eps 1e-6, tanh-form GELU, attention written out with an f32
softmax.  Initialisation draws from a ``torch.Generator`` with the
reference's shapes and scales, not its random bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _normal(gen, shape, std, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * std).to(device)


def _dense(gen, shape, device, scale=None):
    """Fan-in scaled normal (the reference ``Initializer.dense`` rule)."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    if len(shape) == 3:
        fan_in = shape[1]
    return _normal(gen, shape, scale if scale is not None else fan_in ** -0.5,
                   device)


# ---------------------------------------------------------------- CNN

def init_cnn(gen: torch.Generator, *, channels: int = 3, n_classes: int = 10,
             width: int = 32, blocks: int = 2, device):
    p = {"stem": _dense(gen, (3, 3, channels, width), device, scale=0.3)}
    for b in range(blocks):
        w_in = width * (2 ** b)
        w_out = width * (2 ** (b + 1))
        p[f"block{b}"] = {
            "conv1": _dense(gen, (3, 3, w_in, w_out), device, scale=0.1),
            "conv2": _dense(gen, (3, 3, w_out, w_out), device, scale=0.1),
            "skip": _dense(gen, (1, 1, w_in, w_out), device, scale=0.3),
            "gn1_scale": torch.ones(w_out, device=device),
            "gn1_bias": torch.zeros(w_out, device=device),
            "gn2_scale": torch.ones(w_out, device=device),
            "gn2_bias": torch.zeros(w_out, device=device),
        }
    w_final = width * (2 ** blocks)
    p["head"] = {"w": _dense(gen, (w_final, n_classes), device),
                 "b": torch.zeros(n_classes, device=device)}
    return p


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """NHWC x HWIO conv with JAX "SAME" padding (extra pad on the high
    side when the total is odd)."""
    kh, kw = w.shape[0], w.shape[1]
    if kh == kw == 1:
        # a 1x1 conv is a strided matmul ("SAME" pads nothing); this also
        # keeps clear of PyTorch CPU builds whose strided 1x1 conv
        # backward crashes
        return x[:, ::stride, ::stride, :] @ w[0, 0]
    top, bottom = _same_pads(x.shape[1], kh, stride)
    left, right = _same_pads(x.shape[2], kw, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _group_norm(x, scale, bias, groups=8, eps=1e-5):
    b, h, w, c = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xg = x.reshape(b, h, w, g, c // g).to(torch.float32)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(b, h, w, c) * scale + bias).to(x.dtype)


def cnn_apply(params, images):
    """images: (B,H,W,C) -> logits (B, n_classes)."""
    x = F.relu(_conv(images, params["stem"]))
    b = 0
    while f"block{b}" in params:
        pb = params[f"block{b}"]
        h = _conv(x, pb["conv1"], stride=2)
        h = F.relu(_group_norm(h, pb["gn1_scale"], pb["gn1_bias"]))
        h = _conv(h, pb["conv2"])
        h = _group_norm(h, pb["gn2_scale"], pb["gn2_bias"])
        x = F.relu(h + _conv(x, pb["skip"], stride=2))
        b += 1
    x = x.mean(dim=(1, 2))
    return x @ params["head"]["w"] + params["head"]["b"]


# ---------------------------------------------------------------- ViT

def init_vit(gen: torch.Generator, *, image_size: int = 16, patch: int = 4,
             channels: int = 3, d_model: int = 64, layers: int = 3,
             heads: int = 2, n_classes: int = 10, device):
    n_patches = (image_size // patch) ** 2
    d_patch = patch * patch * channels

    def ones(n):
        return torch.ones(n, device=device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    p = {
        "patch_embed": _dense(gen, (d_patch, d_model), device),
        "pos_embed": _normal(gen, (n_patches + 1, d_model), 0.02, device),
        "cls": zeros(1, 1, d_model),
        "blocks": [],
        "final_ln_scale": ones(d_model),
        "final_ln_bias": zeros(d_model),
        "head": {"w": _dense(gen, (d_model, n_classes), device),
                 "b": zeros(n_classes)},
    }
    for _ in range(layers):
        p["blocks"].append({
            "ln1_scale": ones(d_model),
            "ln1_bias": zeros(d_model),
            "wqkv": _dense(gen, (d_model, 3 * d_model), device),
            "wo": _dense(gen, (d_model, d_model), device),
            "ln2_scale": ones(d_model),
            "ln2_bias": zeros(d_model),
            "w1": _dense(gen, (d_model, 4 * d_model), device),
            "b1": zeros(4 * d_model),
            "w2": _dense(gen, (4 * d_model, d_model), device),
            "b2": zeros(d_model),
        })
    meta = {"patch": patch, "heads": heads}
    return p, meta


def _ln(x, scale, bias, eps=1e-6):
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return (((xf - mean) * torch.rsqrt(var + eps)) * scale
            + bias).to(x.dtype)


def vit_apply(params, meta, images):
    patch, heads = meta["patch"], meta["heads"]
    b, hh, ww, c = images.shape
    ph, pw = hh // patch, ww // patch
    x = images.reshape(b, ph, patch, pw, patch, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, ph * pw, patch * patch * c)
    x = x @ params["patch_embed"]
    cls = params["cls"].expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    d = x.shape[-1]
    hd = d // heads
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1_scale"], blk["ln1_bias"])
        qkv = h @ blk["wqkv"]
        q, k, v = torch.split(qkv, d, dim=-1)
        s = x.shape[1]
        q = q.reshape(b, s, heads, hd)
        k = k.reshape(b, s, heads, hd)
        v = v.reshape(b, s, heads, hd)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        att = torch.softmax(att.to(torch.float32), dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, d)
        x = x + o @ blk["wo"]
        h = _ln(x, blk["ln2_scale"], blk["ln2_bias"])
        h = F.gelu(h @ blk["w1"] + blk["b1"], approximate="tanh") \
            @ blk["w2"] + blk["b2"]
        x = x + h
    x = _ln(x, params["final_ln_scale"], params["final_ln_bias"])
    return x[:, 0] @ params["head"]["w"] + params["head"]["b"]


def classification_loss(logits, labels):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
