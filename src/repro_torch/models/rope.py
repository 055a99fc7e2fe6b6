"""Rotary position embeddings: full, partial (ChatGLM3 "2d"), and M-RoPE
(Qwen2-VL) — counterpart of ``repro/models/rope.py``."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def _rotate(x, cos, sin):
    """x: (..., D) with D even; cos/sin: (..., D//2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _angles(positions, rot_dim, theta):
    """positions: (...,) -> (..., rot_dim//2) angles."""
    inv_freq = theta ** (-torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                       device=positions.device) / rot_dim)
    return positions[..., None].to(torch.float32) * inv_freq


def apply_rope(
    x,
    positions,
    *,
    theta: float = 10000.0,
    fraction: float = 1.0,
    mrope_sections: Optional[Sequence[int]] = None,
):
    """Apply rotary embedding.

    x: (B, S, H, D).
    positions: (B, S) int, or (B, S, 3) for M-RoPE (temporal, height, width).
    fraction: apply rope to the first ``fraction*D`` dims (ChatGLM3 uses 0.5).
    mrope_sections: per-axis frequency-block sizes summing to rot_dim//2.
    """
    d = x.shape[-1]
    rot_dim = int(d * fraction)
    rot_dim -= rot_dim % 2
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]

    if mrope_sections is not None:
        assert positions.ndim == 3 and \
            positions.shape[-1] == len(mrope_sections)
        half = rot_dim // 2
        assert sum(mrope_sections) == half, (mrope_sections, half)
        parts, offset = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(_angles(positions[..., i], rot_dim,
                                 theta)[..., offset:offset + sec])
            offset += sec
        ang = torch.cat(parts, dim=-1)
    else:
        if positions.ndim == 3:  # text-only path of an M-RoPE model
            positions = positions[..., 0]
        ang = _angles(positions, rot_dim, theta)  # (B, S, half)

    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)  # (B,S,1,half)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    return torch.cat([_rotate(x_rot, cos, sin), x_pass], dim=-1)



def default_positions(batch: int, seq: int, *, mrope: bool = False,
                      offset=0):
    """``arange(seq) + offset`` broadcast to (B, S) int32, or to (B, S, 3)
    under M-RoPE; on ``offset``'s device when it is a tensor."""
    device = offset.device if isinstance(offset, torch.Tensor) else None
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + offset
    pos = pos.to(torch.int32).expand(batch, seq)
    if mrope:
        pos = pos[..., None].expand(batch, seq, 3)
    return pos
