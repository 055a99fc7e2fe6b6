"""Attention: GQA (+bias), sliding-window / local attention, DeepSeek-V2's
multi-head latent attention (MLA) and the caches of decode (counterpart
of ``repro/models/attention.py``).

Written as the reference writes it, in plain tensor ops: grouped query
heads contract against the raw KV heads (no repeat), scores in f32 scaled
by ``dh ** -0.5``, the causal (and windowed) mask applied with ``NEG_INF``
through a ``where``, then a softmax.  ``F.scaled_dot_product_attention``
is not used: it may sum in another order on the card, and the CPU parity
would then not say what runs there.  Long sequences
(``sq >= cfg.attn_chunk_threshold``) use the flash-style online softmax
over KV chunks (``_chunked_sdpa``), the reference's ``lax.scan`` as a
loop.

The decode cache of a layer is ``{"k", "v": (B, buf, Hkv, D), "pos": (B,
buf)}``, ``pos`` -1 where nothing was written.  ``buf`` is ``max_len``, or
``min(max_len, window)`` for a ring buffer of a windowed layer.  New K/V
are written into the buffer in place (the reference's
``dynamic_update_slice`` returns a new buffer), at the reference's
clamped slot: see ``_cache_start``.  An MLA layer's cache holds only the
compressed latents, ``{"c_kv": (B, max_len, kv_lora), "k_rope": (B,
max_len, rope_dim), "pos"}``, always linear; its per-head K/V are
expanded from them at every step, and its attention contracts q·k over
``qk_nope + qk_rope`` (192 at full width, so the scale is ``192 **
-0.5``) and weights V of ``v_head_dim`` (128).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Initializer, apply_norm, constrain, init_norm,
)
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30


# ================================================================ init

def init_attention(ini: Initializer, cfg: ModelConfig):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": ini.dense((d, nq * hd), ("embed", "qkv")),
        "wk": ini.dense((d, nkv * hd), ("embed", "qkv")),
        "wv": ini.dense((d, nkv * hd), ("embed", "qkv")),
        "wo": ini.dense((nq * hd, d), ("qkv", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.zeros((nq * hd,), ("qkv",))
        p["bk"] = ini.zeros((nkv * hd,), ("qkv",))
        p["bv"] = ini.zeros((nkv * hd,), ("qkv",))
    return p


def init_mla(ini: Initializer, cfg: ModelConfig):
    m = cfg.mla
    d = cfg.d_model
    h = cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ini.dense((d, m.q_lora_rank), ("embed", "kv_lora")),
        "q_norm": init_norm(ini, m.q_lora_rank, cfg.norm_type),
        "wq_b": ini.dense((m.q_lora_rank, h * qk), ("kv_lora", "qkv")),
        "wkv_a": ini.dense((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", "kv_lora")),
        "kv_norm": init_norm(ini, m.kv_lora_rank, cfg.norm_type),
        "wkv_b": ini.dense((m.kv_lora_rank,
                            h * (m.qk_nope_head_dim + m.v_head_dim)),
                           ("kv_lora", "qkv")),
        "wo": ini.dense((h * m.v_head_dim, d), ("qkv", "embed")),
    }


# ================================================================ masks

def _causal_window_mask(q_pos, k_pos, window: int):
    """q_pos: (..., Sq), k_pos: (..., Sk) -> bool mask (..., Sq, Sk)."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    m = dk <= dq
    if window:
        m = m & (dk > dq - window)
    return m


# ================================================================ core attention

def _sdpa(q, k, v, q_pos, k_pos, window: int, k_valid=None):
    """Plain attention. q: (B,Sq,H,D) k/v: (B,Sk,Hkv,D); ``k_valid``
    (B,Sk) masks the keys out of a cache that were never written.

    GQA contracts grouped query heads against the raw KV heads (no
    repeat of K/V)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, sq, hkv, rep, dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).to(torch.float32)
    scores = scores * dh ** -0.5
    mask = _causal_window_mask(q_pos, k_pos, window)[:, None, None]
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, v)
    return out.reshape(b, sq, h, v.shape[-1])


def _chunked_sdpa(q, k, v, q_pos, k_pos, window: int, chunk: int):
    """Flash-style online softmax over KV chunks; O(Sq * chunk)
    transients.  The chunks run in order, as the reference's scan."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    rep = h // hkv
    pad = (-sk) % chunk
    if pad:
        k = torch.cat([k, k.new_zeros((b, pad, *k.shape[2:]))], dim=1)
        v = torch.cat([v, v.new_zeros((b, pad, *v.shape[2:]))], dim=1)
        k_pos = torch.cat([k_pos, k_pos.new_full((b, pad), 2**30)], dim=1)
    scale = dh ** -0.5
    qg = q.reshape(b, sq, hkv, rep, dh)

    m = torch.full((b, hkv, rep, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros((b, hkv, rep, sq), dtype=torch.float32,
                        device=q.device)
    acc = torch.zeros((b, hkv, rep, sq, v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    for c in range(k.shape[1] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        kb, vb, pb = k[:, sl], v[:, sl], k_pos[:, sl]
        s = torch.einsum("bqhrd,bkhd->bhrqk", qg,
                         kb).to(torch.float32) * scale
        mask = _causal_window_mask(q_pos, pb, window)[:, None, None]
        s = torch.where(mask, s, NEG_INF)
        m_cur = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l_sum = l_sum * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bhrqk,bkhd->bhrqd", p.to(q.dtype), vb)
        acc = acc * alpha[..., None].to(q.dtype) + pv
        m = m_cur
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None].to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, v.shape[-1])


def _on_local_shards(core, q, k, v, q_pos, k_pos, k_valid):
    """``core`` on the local shards of DTensor q/k/v (the dry-run's
    meshes).  Attention is independent across sequences and heads, so a
    mesh dim that shards q's batch (dim 0) or heads (dim 2; when it also
    divides the KV heads, so that each shard keeps whole GQA groups)
    shards q, k and v alike and needs no communication; q/k/v are
    redistributed to that layout (other mesh dims replicate) and ``core``
    runs on the local tensors.  Without this, DTensor would have to
    shard the products of the merged (batch, head) dims, for which it has
    no rule."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    heads = []
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(pl, Shard) and pl.dim == 0:
            heads.append(Shard(0))
        elif (isinstance(pl, Shard) and pl.dim == 2
              and k.shape[2] % n == 0):
            heads.append(Shard(2))
        else:
            heads.append(Replicate())
    rows = [Shard(0) if pl == Shard(0) else Replicate() for pl in heads]

    def local(x, placements):
        if x is None:
            return None
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, placements).to_local()

    out = core(local(q, heads), local(k, heads), local(v, heads),
               local(q_pos, rows), local(k_pos, rows),
               local(k_valid, rows)).contiguous()
    shape = (*q.shape[:3], v.shape[-1])
    return DTensor.from_local(out, mesh, heads, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _split_heads(t, heads: int, head_dim: int):
    """(B, S, heads * head_dim) -> (B, S, heads, head_dim).  A DTensor
    whose last dim is split over mesh dims whose product does not divide
    ``heads`` gathers that dim first (XLA's choice too): DTensor cannot
    view a shard that cuts through a head."""
    placements = getattr(t, "placements", None)
    if placements is not None:
        mesh, last = t.device_mesh, t.ndim - 1
        on_last = [j for j, pl in enumerate(placements)
                   if pl.is_shard(last)]
        if heads % math.prod(mesh.size(j) for j in on_last):
            from torch.distributed.tensor import Replicate
            t = constrain(t, [Replicate() if j in on_last else pl
                              for j, pl in enumerate(placements)])
    return t.reshape(*t.shape[:2], heads, head_dim)


def _merge_heads(t):
    """(B, S, H, D) -> (B, S, H * D); a DTensor's gradient is brought to
    the merged layout before it is viewed back into heads."""
    out = t.reshape(*t.shape[:2], -1)
    return constrain(out, getattr(out, "placements", None))


def sdpa(q, k, v, q_pos, k_pos, cfg: ModelConfig, window: int,
         k_valid=None):
    """The chunked path for long queries, unless a cache's ``k_valid``
    mask is given (the reference's rule).  DTensor inputs run on their
    local shards (``_on_local_shards``)."""
    if q.shape[1] >= cfg.attn_chunk_threshold and k_valid is None:
        def core(q, k, v, q_pos, k_pos, _):
            return _chunked_sdpa(q, k, v, q_pos, k_pos, window,
                                 cfg.attn_chunk)
    else:
        def core(q, k, v, q_pos, k_pos, k_valid):
            return _sdpa(q, k, v, q_pos, k_pos, window, k_valid)
    if hasattr(q, "placements"):           # a DTensor
        return _on_local_shards(core, q, k, v, q_pos, k_pos, k_valid)
    return core(q, k, v, q_pos, k_pos, k_valid)


# ================================================================ GQA layer

def _cache_start(cache_index: int, s: int, buf_len: int) -> int:
    """Where ``s`` new tokens go in a buffer of ``buf_len``: the slot
    ``cache_index % buf_len``, clamped as ``jax.lax.dynamic_update_slice``
    clamps its start so that the update fits, to ``buf_len - s``.  A
    chunk that would run past the end of a ring buffer therefore lands
    at ``buf_len - s`` and overwrites the slots before it, as in the
    reference."""
    return max(0, min(cache_index % buf_len, buf_len - s))


def attention_forward(p, x, positions, cfg: ModelConfig, *, window: int,
                      cache=None, cache_index=None):
    """x: (B,S,D) -> (out (B,S,D), new_cache).

    Without a cache, attention over the sequence and ``new_cache`` None.
    With one (prefill at ``cache_index`` 0, or a decode step), the new
    K/V and positions are written into ``cache`` in place at
    ``_cache_start`` and the queries attend to the whole buffer, masked
    by positions (causal, windowed) and by the filled slots;
    ``new_cache`` is ``cache`` itself.  ``cache_index`` is a host int.
    """
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, nq, hd)
    k = _split_heads(k, nkv, hd)
    v = _split_heads(v, nkv, hd)

    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction,
                   mrope_sections=cfg.mrope_sections)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction,
                   mrope_sections=cfg.mrope_sections)

    q_pos1d = positions[..., 0] if positions.ndim == 3 else positions
    if cache is None:
        out = sdpa(q, k, v, q_pos1d, q_pos1d, cfg, window)
    else:
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        start = _cache_start(cache_index, s, ck.shape[1])
        sl = slice(start, start + s)
        ck[:, sl] = k.to(ck.dtype)
        cv[:, sl] = v.to(cv.dtype)
        cpos[:, sl] = q_pos1d.to(cpos.dtype).expand(b, s)
        k_valid = (cpos <= q_pos1d[:, -1:]) & (cpos >= 0)  # filled slots
        out = sdpa(q, ck, cv, q_pos1d, cpos, cfg, window, k_valid=k_valid)
    return _merge_heads(out) @ p["wo"], cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, window: int,
                    dtype, ring: bool = False, device="cpu"):
    """An empty cache: ``max_len`` slots, or ``min(max_len, window)`` for
    a ring buffer of a windowed layer; positions -1."""
    hd = cfg.resolved_head_dim
    buf = min(max_len, window) if (window and ring) else max_len
    shape = (batch, buf, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, buf), -1, dtype=torch.int32,
                          device=device),
    }


# ================================================================ MLA layer

def mla_forward(p, x, positions, cfg: ModelConfig, *, cache=None,
                cache_index=None):
    """DeepSeek-V2 Multi-head Latent Attention: x (B,S,D) -> (out,
    new_cache).

    With a cache, the new latents ``(c_kv, k_rope)`` and positions are
    written in place at ``cache_index``, clamped as
    ``dynamic_update_slice`` clamps (to ``max_len - s``), and the queries
    attend to the whole buffer, masked by the filled slots; ``new_cache``
    is ``cache`` itself.
    """
    m = cfg.mla
    b, s, d = x.shape
    h = cfg.n_heads
    q = apply_norm(p["q_norm"], x @ p["wq_a"], cfg.norm_type) @ p["wq_b"]
    q = _split_heads(q, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)

    kv_a = x @ p["wkv_a"]  # (B,S,kv_lora+rope)
    c_kv, k_rope = torch.split(
        kv_a, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = apply_norm(p["kv_norm"], c_kv, cfg.norm_type)

    pos1d = positions[..., 0] if positions.ndim == 3 else positions
    q_rope = apply_rope(q_rope, pos1d, theta=cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], pos1d,
                        theta=cfg.rope_theta)[:, :, 0, :]

    if cache is not None:
        cc, cr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
        start = max(0, min(int(cache_index), cc.shape[1] - s))
        sl = slice(start, start + s)
        cc[:, sl] = c_kv.to(cc.dtype)
        cr[:, sl] = k_rope.to(cr.dtype)
        cpos[:, sl] = pos1d.to(cpos.dtype).expand(b, s)
        k_valid = (cpos <= pos1d[:, -1:]) & (cpos >= 0)
        c_kv_all, k_rope_all, kpos = cc, cr, cpos
    else:
        c_kv_all, k_rope_all, kpos = c_kv, k_rope, pos1d
        k_valid = None

    # expand the latent to per-head K (nope part) and V
    kv = c_kv_all @ p["wkv_b"]  # (B,T,h*(nope+v))
    t = kv.shape[1]
    kv = _split_heads(kv, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope_all[:, :, None, :].expand(
        b, t, h, m.qk_rope_head_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa(q_full, k, v, pos1d, kpos, cfg, window=0, k_valid=k_valid)
    return _merge_heads(out) @ p["wo"], cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device="cpu"):
    """An empty MLA cache: the latents of ``max_len`` positions, -1
    where nothing was written."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }
