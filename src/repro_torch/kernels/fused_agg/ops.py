"""The low-rank flushes of the fused decode-aggregate pass — counterpart
of ``repro/kernels/fused_agg/{ops,ref}.py``'s ``lowrank_accumulate`` and
``sketch_accumulate``.

Each computes sum_i w_i * decode(enc_i) for a factored wire format
without materializing the (B, ...) decoded cohort: the (client, rank)
axes merge into one contraction axis, so the flush is one
(m, B·r) x (B·r, n) GEMM per batch matrix and the dense per-client outer
products never exist.  They are not Pallas kernels in the reference,
whose ``ops.py`` aliases them to the jnp reference because XLA's GEMM is
already the right kernel; here they are ``torch.matmul`` (cuBLAS on the
card).  The qblock flush, a hand-written kernel, is in ``kernel.py``.
"""
from __future__ import annotations

import torch


def _merged_gemm(lhs, rhs):
    """sum_i lhs_i @ rhs_i as one batched GEMM over a merged (B*r) axis.

    lhs: (B, *batch, m, r), rhs: (B, *batch, r, n) -> (*batch, m, n).
    """
    b, r = lhs.shape[0], lhs.shape[-1]
    lm = torch.movedim(lhs, 0, -2)                     # (*batch, m, B, r)
    lm = lm.reshape(*lm.shape[:-2], b * r)             # (*batch, m, B*r)
    rm = torch.movedim(rhs, 0, -3)                     # (*batch, B, r, n)
    rm = rm.reshape(*rm.shape[:-3], b * r, rm.shape[-1])
    return lm @ rm


def _client_weights(weights, ndim):
    """(B,) weights shaped to broadcast over a (B, ...) operand."""
    return weights.to(torch.float32).reshape((-1,) + (1,) * (ndim - 1))


def lowrank_accumulate(u, s, vt, weights):
    """sum_i w_i * U_i diag(s_i) V_iᵀ.  u: (B, *batch, m, r),
    s: (B, *batch, r), vt: (B, *batch, r, n), weights: (B,)."""
    ws = s.to(torch.float32) * _client_weights(weights, s.ndim)
    us = u.to(torch.float32) * ws[..., None, :]
    return _merged_gemm(us, vt.to(torch.float32))


def sketch_accumulate(q, b, weights):
    """sum_i w_i * Q_i B_i.  q: (B, *batch, m, r), b: (B, *batch, r, n)."""
    qw = q.to(torch.float32) * _client_weights(weights, q.ndim)
    return _merged_gemm(qw, b.to(torch.float32))
