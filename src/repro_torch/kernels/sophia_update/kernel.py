"""``sophia_update``: Sophia's fused momentum + clipped diagonal step.

  m' = b1 m + (1-b1) g,   d = clip(m' / max(h, eps), -rho, rho)
                                                   -> (d, m') in f32

Replaces the Pallas TPU kernel ``repro/kernels/sophia_update/kernel.py::
sophia_update`` (with ``ref.py``/``ops.py``) by a Triton kernel.  Bound on
an H100: memory — three f32 reads and two writes per element (20 B)
against ~6 flops, so 3.35 TB/s sets the floor.  Design: one masked 1-D
pass over the flattened operands, 1024 elements per program, every
element read and written once; no tiling or padding copies (the TPU
kernel padded to (8, 128) tiles).  ``b1``, ``1-b1`` (computed on the
host, as the plain version's constant), ``rho`` and ``eps`` are runtime
scalars, FMA contraction is off and the division is IEEE (``div_rn``;
Triton's ``/`` is the approximate ``div.full``), so the kernel rounds
each product, sum and quotient as the plain version does.

Dispatch follows the tensors: CPU tensors take ``sophia_update_plain``,
CUDA tensors launch the Triton kernel or raise.  ``triton`` is imported
only when a kernel is first launched.  ``sophia_update.launches`` counts
kernel launches.
"""
from __future__ import annotations

import functools

import torch

BLOCK = 1024


def sophia_update_plain(g, m, h, *, b1: float = 0.9, rho: float = 0.05,
                        eps: float = 1e-12):
    """The kernel's math in plain PyTorch (the reference's ``ref.py``)."""
    m_new = b1 * m.to(torch.float32) + (1 - b1) * g.to(torch.float32)
    d = torch.clamp(m_new / torch.clamp(h.to(torch.float32), min=eps),
                    -rho, rho)
    return d, m_new


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def sophia_update_kernel(g_ptr, m_ptr, h_ptr, d_ptr, m_out_ptr, numel,
                             b1, omb1, rho, eps, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < numel
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        m = tl.load(m_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        h = tl.load(h_ptr + offs, mask=mask, other=1.0).to(tl.float32)
        m = b1 * m + omb1 * g
        d = tl.math.div_rn(m, tl.maximum(h, eps))     # IEEE, as torch
        d = tl.minimum(tl.maximum(d, -rho), rho)
        tl.store(d_ptr + offs, d, mask=mask)
        tl.store(m_out_ptr + offs, m, mask=mask)

    return triton, sophia_update_kernel


def sophia_update(g, m, h, *, b1: float = 0.9, rho: float = 0.05,
                  eps: float = 1e-12):
    """Fused Sophia direction; returns (d, m') as f32 in ``g``'s shape."""
    if not (g.shape == m.shape == h.shape):
        raise ValueError(f"sophia_update shape mismatch: {tuple(g.shape)}, "
                         f"{tuple(m.shape)}, {tuple(h.shape)}")
    devices = {g.device, m.device, h.device}
    if len(devices) != 1:
        raise ValueError(f"sophia_update operands on several devices: "
                         f"{sorted(map(str, devices))}")
    if g.device.type == "cpu":
        return sophia_update_plain(g, m, h, b1=b1, rho=rho, eps=eps)
    if g.device.type != "cuda":
        raise ValueError(f"sophia_update: unsupported device {g.device}")
    if not g.dtype.is_floating_point:
        raise TypeError(f"sophia_update wants a floating g, got {g.dtype}")
    if m.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError("sophia_update keeps its m and h in float32")
    g, m, h = g.contiguous(), m.contiguous(), h.contiguous()
    outs = [torch.empty(g.shape, device=g.device, dtype=torch.float32)
            for _ in range(2)]
    numel = g.numel()
    if numel == 0:
        return tuple(outs)
    triton, kernel = _triton_kernel()
    with torch.cuda.device(g.device):
        kernel[(triton.cdiv(numel, BLOCK),)](
            g, m, h, *outs, numel, b1, 1 - b1, rho, eps, BLOCK=BLOCK,
            num_warps=4, enable_fp_fusion=False)
    sophia_update.launches += 1
    return tuple(outs)


sophia_update.launches = 0
