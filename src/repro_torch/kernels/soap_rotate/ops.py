"""Full SOAP rotated-Adam step composed from the port's kernels
(counterpart of ``repro/kernels/soap_rotate/ops.py``):

  G' = Q_L^T G Q_R   (matmul_fused, transposes as strides)
  N, M', V' = adam_moments(G', M, V)
  D  = Q_L N Q_R^T   (matmul_fused)

Operands are batched ``(..., m, n)`` (the client axis, expert stacks);
``ql`` or ``qr`` may be None for the one-sided case (identity on that
side).  Each piece dispatches on the tensors' device, so CPU tensors run
the plain versions and CUDA tensors the kernels.
"""
from __future__ import annotations

from repro_torch.kernels.ns_ortho.kernel import (
    matmul_fused, matmul_fused_plain,
)
from repro_torch.kernels.soap_rotate.kernel import (
    adam_moments, adam_moments_plain,
)


def rotate(g, ql, qr, inverse: bool = False, matmul=matmul_fused):
    """Q_L^T G Q_R (or Q_L G Q_R^T when ``inverse``); None side = identity."""
    if ql is not None:
        g = matmul(ql if inverse else ql.transpose(-1, -2), g)
    if qr is not None:
        g = matmul(g, qr.transpose(-1, -2) if inverse else qr)
    return g


def soap_rotated_update(g, ql, qr, m, v, *, b1: float = 0.95,
                        b2: float = 0.95, eps: float = 1e-8, step=None):
    """Returns (D, M', V') in f32."""
    g_rot = rotate(g.float(), ql, qr)
    n, m_new, v_new = adam_moments(g_rot, m, v, b1=b1, b2=b2, eps=eps,
                                   step=step)
    return rotate(n, ql, qr, inverse=True), m_new, v_new


def soap_rotated_update_plain(g, ql, qr, m, v, *, b1: float = 0.95,
                              b2: float = 0.95, eps: float = 1e-8,
                              step=None):
    """The same composition of the kernels' plain versions, on any
    device: what ``soap_rotated_update`` is held against."""
    g_rot = rotate(g.float(), ql, qr, matmul=matmul_fused_plain)
    n, m_new, v_new = adam_moments_plain(g_rot, m, v, b1=b1, b2=b2, eps=eps,
                                         step=step)
    return rotate(n, ql, qr, inverse=True, matmul=matmul_fused_plain), \
        m_new, v_new
