"""Ops that DTensor's sharding propagation does not take, for the
dry-run's steps on DTensors; on plain tensors each is the plain op.

``qr_q(a)`` is the Q of ``torch.linalg.qr(a)``, which DTensor has no rule
for.  Where XLA's SPMD partitioner cannot split an op, it gathers the
operand and runs the op whole on every device, and so does this.  On a DTensor the
operand is redistributed to ``Replicate()`` on every mesh axis (an
all-gather per sharded axis, an all-reduce per partial one), the QR runs
on the local full tensor, and Q goes back to ``a``'s placements (a
partial placement as replicated): a local slice, no communication.  A
plain tensor goes straight to ``torch.linalg.qr``.  SOAP's eigenbasis
refresh takes it, so that the dry-run's SOAP steps on DTensors hold the
refresh.

``client_contract(w, x)`` is ``torch.tensordot(w, x, dims=([0], [0]))``
over a client axis: sum_i w_i x_i.  DTensor lowers a tensordot to a
reshape and a matmul, and the reshape of a leaf sharded on two dims
gives a placement its matmul rule does not take.  The client axis of a
stacked leaf is never sharded, so on a DTensor each rank contracts its
own shard, no collective, and the result keeps the leaf's placements
(less the client axis).
"""
from __future__ import annotations

import sys

import torch


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (one exists only once its module is
    loaded, so a plain run imports nothing of ``torch.distributed``)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def qr_q(a):
    """Q of the reduced QR of ``a`` (..., m, n)."""
    if not is_dtensor(a):
        return torch.linalg.qr(a)[0]
    from torch.distributed.tensor import DTensor, Replicate
    mesh = a.device_mesh
    whole = [Replicate()] * mesh.ndim
    q = torch.linalg.qr(a.redistribute(mesh, whole).to_local())[0]
    back = [Replicate() if p.is_partial() else p for p in a.placements]
    return DTensor.from_local(q, mesh, whole, run_check=False).redistribute(
        mesh, back)


def client_contract(w, x):
    """sum_i w[i] x[i] over dim 0 of ``x`` (``w`` plain or replicated)."""
    if not is_dtensor(x):
        return torch.tensordot(w, x, dims=([0], [0]))
    from torch.distributed.tensor import DTensor, Shard
    if any(p.is_shard(0) or p.is_partial() for p in x.placements):
        raise ValueError(f"a client axis sharded or partial: {x.placements}")
    if is_dtensor(w):
        w = w.full_tensor()
    out = torch.tensordot(w, x.to_local(), dims=([0], [0]))
    placements = [Shard(p.dim - 1) if p.is_shard() else p
                  for p in x.placements]
    return DTensor.from_local(out, x.device_mesh, placements,
                              run_check=False, shape=x.shape[1:],
                              stride=torch.empty(x.shape[1:],
                                                 device="meta").stride())
