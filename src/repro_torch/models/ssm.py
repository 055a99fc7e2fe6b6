"""Mamba-1 selective SSM (falcon-mamba-7b family), counterpart of
``repro/models/ssm.py``.

Training and prefill run the selective scan in chunks: the chunk is the
largest divisor of the sequence length that is at most ``scan_chunk``
(no padding: a padded step would advance the state, since dt(0) > 0).
The chunks run in order (the reference's ``lax.scan``), and inside a
chunk the recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t`` is a
log-depth (Hillis–Steele) inclusive scan of the pairs ``(a, b)`` under
``(a1, b1)∘(a2, b2) = (a1·a2, a2·b1 + b2)`` (``scan_pairs``; the
reference's ``associative_scan``, which PyTorch lacks).  It is built from
slices and concatenations, so ``vmap`` and ``grad`` compose through it,
and it takes ``log2(chunk)`` steps where a loop over time would launch
``chunk`` sets of small kernels a chunk.  The association order is not
JAX's, so the parity with the reference is within an f32 bound, not
bitwise.  The transient is ``(B, chunk, d_inner, d_state)`` in f32: 537
MB a tensor at Falcon-Mamba-7B's width, batch 8, chunk 128.

Decode is an O(1) state update.  The cache ``{"conv": (B, d_conv-1,
d_inner), "ssm": (B, d_inner, d_state)}`` is written in place and
returned.  A forward over ``s > 1`` tokens with a cache (prefill) starts
from an empty state, as the reference's does: the conv zero-pads and the
scan starts at h = 0 whatever the cache holds; only the cache's conv
tail is carried into the new one.  So a chunked prefill that continues a
non-empty cache is wrong in both packages.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Initializer


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or math.ceil(cfg.d_model / 16)
    return d_inner, dt_rank


def init_mamba(ini: Initializer, cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, dt_rank = _dims(cfg)
    a_init = torch.log(torch.arange(1, s.d_state + 1, dtype=torch.float32)
                       .expand(d_inner, s.d_state))
    return {
        "in_proj": ini.dense((d, 2 * d_inner), ("embed", "ffn")),
        "conv_w": ini.dense((s.d_conv, d_inner), ("conv", "ffn"),
                            scale=0.5),
        "conv_b": ini.zeros((d_inner,), ("ffn",)),
        "x_proj": ini.dense((d_inner, dt_rank + 2 * s.d_state),
                            ("ffn", "state")),
        "dt_proj": ini.dense((dt_rank, d_inner), ("state", "ffn")),
        "dt_bias": ini.constant(
            torch.log(torch.expm1(torch.full((d_inner,), 0.01))), ("ffn",)),
        "A_log": ini.constant(a_init, ("ffn", "state")),
        "D": ini.ones((d_inner,), ("ffn",)),
        "out_proj": ini.dense((d_inner, d), ("ffn", "embed")),
    }


def scan_pairs(a, b, dim: int):
    """Inclusive scan of the pairs ``(a_t, b_t)`` along ``dim`` under
    ``(a1, b1)∘(a2, b2) = (a1·a2, a2·b1 + b2)``, in ``ceil(log2 n)``
    steps: returns (the running products of ``a``, ``h`` with ``h_t =
    a_t h_{t-1} + b_t`` from h = 0)."""
    n = a.shape[dim]
    shift = 1
    while shift < n:
        a_cur = a.narrow(dim, shift, n - shift)
        b_new = a_cur * b.narrow(dim, 0, n - shift) \
            + b.narrow(dim, shift, n - shift)
        a_new = a.narrow(dim, 0, n - shift) * a_cur
        a = torch.cat([a.narrow(dim, 0, shift), a_new], dim=dim)
        b = torch.cat([b.narrow(dim, 0, shift), b_new], dim=dim)
        shift *= 2
    return a, b


def _causal_conv(xb, conv_w):
    """Depthwise causal conv over the sequence by shifted adds, from zero
    padding (d_conv is tiny)."""
    s = xb.shape[1]
    d_conv = conv_w.shape[0]
    conv = torch.zeros_like(xb)
    for i in range(d_conv):
        shift = d_conv - 1 - i
        shifted = F.pad(xb, (0, 0, shift, 0))[:, :s]
        conv = conv + shifted * conv_w[i]
    return conv


def _ssm_params(p, xz, cfg):
    """Common per-step projections. xz: (..., d_inner) post-conv branch."""
    s = cfg.ssm
    _, dt_rank = _dims(cfg)
    proj = xz @ p["x_proj"]  # (..., dt_rank + 2*state)
    dt, b_mat, c_mat = torch.split(proj, [dt_rank, s.d_state, s.d_state],
                                   dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])  # (..., d_inner)
    return dt, b_mat, c_mat


def _selective_scan_chunked(p, x, cfg: ModelConfig):
    """x: (B,S,d_inner) conv+silu branch. Returns y (B,S,d_inner) and the
    last state (B,d_inner,state) in f32, from h = 0."""
    s_cfg = cfg.ssm
    b, s, d_inner = x.shape
    chunk = min(s_cfg.scan_chunk, s)
    while s % chunk:
        chunk -= 1
    a = -torch.exp(p["A_log"].to(torch.float32))  # (d_inner, state)
    h = torch.zeros((b, d_inner, s_cfg.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(s // chunk):
        x_blk = x[:, c * chunk:(c + 1) * chunk]  # (B,C,d_inner)
        dt, b_mat, c_mat = _ssm_params(p, x_blk, cfg)
        dt = dt.to(torch.float32)
        da = torch.exp(dt[..., None] * a)                       # (B,C,d,n)
        dbx = (dt * x_blk.to(torch.float32))[..., None] * \
            b_mat.to(torch.float32)[..., None, :]               # (B,C,d,n)
        da_s, dbx_s = scan_pairs(da, dbx, 1)
        hs = da_s * h[:, None] + dbx_s                          # (B,C,d,n)
        y = torch.einsum("bcdn,bcn->bcd", hs, c_mat.to(torch.float32))
        h = hs[:, -1]
        ys.append(y.to(x_blk.dtype))
    return torch.cat(ys, dim=1), h


def mamba_forward(p, x, cfg: ModelConfig, *, cache=None):
    """Full-sequence (train/prefill) or single-step (decode) Mamba block:
    (out (B,S,D), the cache written in place, or None without one)."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    xz = x @ p["in_proj"]
    xb, z = torch.chunk(xz, 2, dim=-1)  # (B,S,d_inner) each

    if cache is None or s > 1:
        # training, or prefill (from an empty state, as the reference)
        conv = F.silu(_causal_conv(xb, p["conv_w"]) + p["conv_b"])
        y, h_final = _selective_scan_chunked(p, conv, cfg)
        if cache is not None:
            tail = torch.cat([cache["conv"], xb.to(cache["conv"].dtype)],
                             dim=1)
            cache["conv"].copy_(tail[:, -(s_cfg.d_conv - 1):])
            cache["ssm"].copy_(h_final)
    else:
        window = torch.cat([cache["conv"], xb.to(cache["conv"].dtype)],
                           dim=1)  # (B,d_conv,d)
        conv = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
        conv = F.silu(conv)[:, None]  # (B,1,d_inner)
        dt, b_mat, c_mat = _ssm_params(p, conv, cfg)
        a = -torch.exp(p["A_log"].to(torch.float32))
        dt = dt[:, 0].to(torch.float32)
        da = torch.exp(dt[..., None] * a)  # (B,d,n)
        dbx = (dt * conv[:, 0].to(torch.float32))[..., None] * \
            b_mat[:, 0].to(torch.float32)[:, None, :]
        h = da * cache["ssm"] + dbx
        y = torch.einsum("bdn,bn->bd", h, c_mat[:, 0].to(torch.float32))
        y = y.to(x.dtype)[:, None]
        cache["conv"].copy_(window[:, 1:])
        cache["ssm"].copy_(h)

    y = y + _d_skip(p, conv)
    y = y * F.silu(z)
    return y @ p["out_proj"], cache


def _d_skip(p, conv):
    return conv * p["D"]


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    s = cfg.ssm
    d_inner, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_inner, s.d_state), dtype=torch.float32,
                           device=device),
    }
