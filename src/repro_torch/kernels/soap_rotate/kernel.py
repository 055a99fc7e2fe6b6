"""``adam_moments``: SOAP's fused rotated-space Adam moment pass.

  m' = b1 m + (1-b1) g,  v' = b2 v + (1-b2) g^2,
  n  = (m'/bc1) / (sqrt(v'/bc2) + eps)          -> (n, m', v') in f32

Replaces the Pallas TPU kernel ``repro/kernels/soap_rotate/kernel.py::
adam_moments`` with a Triton kernel.  Bound on an H100: memory — three
f32 reads and three writes per element (24 B) against ~10 flops, so
3.35 TB/s sets the floor.  Design: one masked 1-D pass over the flattened
operands, 1024 elements per program, every element read and written once;
no tiling or padding copies (the TPU kernel padded to (8, 128) tiles).
The bias corrections ``bc = 1 - b**(step+1)`` arrive as runtime scalars,
so a new step count launches the same compiled kernel; ``step=None`` is
the uncorrected form (bc = 1).

Dispatch follows the tensors: CPU tensors take ``adam_moments_plain``,
CUDA tensors launch the Triton kernel or raise.  ``triton`` is imported
only when a kernel is first launched.  ``adam_moments.launches`` counts
kernel launches.
"""
from __future__ import annotations

import functools

import torch

BLOCK = 1024


def bias_corrections(b1: float, b2: float, step=None):
    """(bc1, bc2) for local step ``step`` (t = step + 1); ones for None."""
    if step is None:
        return 1.0, 1.0
    t = float(step) + 1.0
    return 1.0 - b1 ** t, 1.0 - b2 ** t


def adam_moments_plain(g, m, v, *, b1: float = 0.95, b2: float = 0.95,
                       eps: float = 1e-8, step=None):
    """The kernel's math in plain PyTorch."""
    bc1, bc2 = bias_corrections(b1, b2, step)
    g = g.to(torch.float32)
    m_new = b1 * m.to(torch.float32) + (1 - b1) * g
    v_new = b2 * v.to(torch.float32) + (1 - b2) * g * g
    n = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    return n, m_new, v_new


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def adam_moments_kernel(g_ptr, m_ptr, v_ptr, n_ptr, m_out_ptr, v_out_ptr,
                            numel, b1, omb1, b2, omb2, eps, bc1, bc2,
                            BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < numel
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        m = tl.load(m_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        v = tl.load(v_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        m = b1 * m + omb1 * g
        v = b2 * v + omb2 * g * g
        n = (m / bc1) / (tl.sqrt(v / bc2) + eps)
        tl.store(n_ptr + offs, n, mask=mask)
        tl.store(m_out_ptr + offs, m, mask=mask)
        tl.store(v_out_ptr + offs, v, mask=mask)

    return triton, adam_moments_kernel


def adam_moments(g, m, v, *, b1: float = 0.95, b2: float = 0.95,
                 eps: float = 1e-8, step=None):
    """Fused moment pass; returns (n, m', v') as f32 in ``g``'s shape."""
    if not (g.shape == m.shape == v.shape):
        raise ValueError(f"adam_moments shape mismatch: {tuple(g.shape)}, "
                         f"{tuple(m.shape)}, {tuple(v.shape)}")
    devices = {g.device, m.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"adam_moments operands on several devices: "
                         f"{sorted(map(str, devices))}")
    if g.device.type == "cpu":
        return adam_moments_plain(g, m, v, b1=b1, b2=b2, eps=eps, step=step)
    if g.device.type != "cuda":
        raise ValueError(f"adam_moments: unsupported device {g.device}")
    if not g.dtype.is_floating_point:
        raise TypeError(f"adam_moments wants a floating g, got {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("adam_moments keeps its moments in float32")
    g, m, v = g.contiguous(), m.contiguous(), v.contiguous()
    outs = [torch.empty(g.shape, device=g.device, dtype=torch.float32)
            for _ in range(3)]
    numel = g.numel()
    if numel == 0:
        return tuple(outs)
    bc1, bc2 = bias_corrections(b1, b2, step)
    triton, kernel = _triton_kernel()
    with torch.cuda.device(g.device):
        kernel[(triton.cdiv(numel, BLOCK),)](
            g, m, v, *outs, numel, b1, 1 - b1, b2, 1 - b2, eps, bc1, bc2,
            BLOCK=BLOCK, num_warps=4)
    adam_moments.launches += 1
    return tuple(outs)


adam_moments.launches = 0
