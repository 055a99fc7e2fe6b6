"""Newton–Schulz orthogonalisation over ``matmul_fused`` — counterpart of
``repro/kernels/ns_ortho/ops.py`` (``ns_iteration_pallas``,
``newton_schulz_pallas``, ``newton_schulz``) and of its oracle
``ref.py``.

Each matrix is orthogonalised as the reference does it: a tall one
(m > n) as its transpose (a view, no copy), pre-scaled by its own
Frobenius norm + eps, then ``steps`` quintic steps with ``NS_COEFFS``
(a, b, c):

  A = X X^T,   B = c (A A) + b A,   X' = B X + a X.

Here every step runs over a whole list of matrices at once: each of the
three products is one ``matmul_fused_group`` call over every matrix of
the list (A: ``(X, X^T)``; B: ``(A, A)`` with aux A, alpha c, beta b; X':
``(B, X)`` with aux X, alpha 1, beta a), so ``steps`` steps make
3 * steps grouped calls: 15 kernel launches at 5 steps while the list
holds at most ``MAX_PROBLEMS`` (227) problems, more only when a group
splits.  Leading dims of a matrix (the cohort's client axis, expert
stacks) fold into its problem's batch; operands are read through their
strides, so the transposes cost no copy.  The pre-scale is taken per
trailing matrix, as the reference vmaps one client at a time: a norm over
a whole stacked (S, m, n) leaf would be wrong.

``newton_schulz_group_plain`` repeats ``ref.ns_iteration``'s math per
matrix in plain PyTorch (the tests and ``chip_smoke.py`` hold the kernel
path against it).  On CPU tensors ``matmul_fused_group`` itself takes its
plain version, so the same entry point runs everywhere; on CUDA tensors
it launches the kernel.  The composition launches no kernel of its own:
its launches are ``matmul_fused``'s, counted by ``matmul_fused.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ns_ortho.kernel import matmul_fused_group

NS_COEFFS = (3.4445, -4.7750, 2.0315)


def _prescaled(g, eps):
    """(X, transposed): g as a wide matrix (a view), divided by its own
    Frobenius norm + eps over the last two dims, in f32."""
    transpose = g.shape[-2] > g.shape[-1]
    x = g.transpose(-1, -2) if transpose else g
    x = x.to(torch.float32)
    norm = torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    return x / (norm + eps), transpose


def newton_schulz_group(mats, steps: int = 5, eps: float = 1e-7):
    """Orthogonalise every (..., m, n) matrix of ``mats``: 3 grouped
    ``matmul_fused`` calls a step over the whole list.  Returns f32
    outputs in the inputs' shapes (a tall input's output is a transposed
    view)."""
    a, b, c = NS_COEFFS
    pre = [_prescaled(g, eps) for g in mats]
    xs = [x for x, _ in pre]
    for _ in range(steps):
        aa = matmul_fused_group([(x, x.transpose(-1, -2), None, 1.0, 0.0)
                                 for x in xs])
        bb = matmul_fused_group([(m, m, m, c, b) for m in aa])
        xs = matmul_fused_group([(m, x, x, 1.0, a) for m, x in zip(bb, xs)])
    return [x.transpose(-1, -2) if t else x for x, (_, t) in zip(xs, pre)]


def newton_schulz_group_plain(mats, steps: int = 5, eps: float = 1e-7):
    """``ref.newton_schulz`` per matrix in plain PyTorch, batched over the
    leading dims."""
    a, b, c = NS_COEFFS
    out = []
    for g in mats:
        x, transpose = _prescaled(g, eps)
        for _ in range(steps):
            aa = x @ x.transpose(-1, -2)
            bb = b * aa + c * (aa @ aa)
            x = a * x + bb @ x
        out.append(x.transpose(-1, -2) if transpose else x)
    return out


def newton_schulz(g, steps: int = 5, eps: float = 1e-7):
    """One (m, n) matrix, or (E, m, n) orthogonalised matrix by matrix (the
    reference vmaps 3-D inputs over dim 0): the group of one."""
    if g.ndim not in (2, 3):
        raise ValueError(f"newton_schulz wants (m, n) or (E, m, n), got "
                         f"{tuple(g.shape)}")
    return newton_schulz_group([g], steps=steps, eps=eps)[0]
