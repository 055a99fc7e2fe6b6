"""Legacy FedPAC_light compression shims over ``core.transport``
(counterpart of ``repro/core/compression.py``).

The wire codecs superseded this module: uploads are encoded ``WireMsg``
structures and byte accounting derives from ``transport.wire_bytes``.
These shims keep the historical entry points by delegating to the
``lowrank_svd`` codec, so the compressed leaves and the counted leaves
are one set by construction.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.transport import Dense, LowRankSVD, wire_bytes
from repro_torch.utils.tree import tree_map


def svd_truncate(mat, rank: int):
    """Rank-r truncation of the trailing two dims."""
    u, s, vt = torch.linalg.svd(mat.to(torch.float32), full_matrices=False)
    r = min(rank, s.shape[-1])
    return (u[..., :, :r] * s[..., None, :r]) @ vt[..., :r, :]


def make_svd_codec(rank: int) -> Callable:
    """Legacy stacked round-trip: rank-r SVD per client, dense result.

    Takes a stacked tree with a leading (S,) client axis; a leaf is
    compressed iff its per-client shape has ``ndim >= 2`` and both
    trailing dims above the rank — the rule accounting uses.
    """
    return LowRankSVD(rank=rank).roundtrip


def _one_client(tree):
    return tree_map(lambda x: x[None], tree)


def compressed_bytes(theta, rank: int) -> int:
    """Bytes uploaded per client for a rank-r factored (per-client)
    Theta, measured from the message the ``lowrank_svd`` codec builds."""
    return wire_bytes(LowRankSVD(rank=rank).encode(_one_client(theta)))


def round_comm_bytes(params, theta=None, *, compressed_rank=None) -> int:
    """Per-round upload bytes for one client (Table 6 accounting)."""
    total = wire_bytes(Dense().encode(_one_client(params)))
    if theta is not None:
        if compressed_rank:
            total += compressed_bytes(theta, compressed_rank)
        else:
            total += wire_bytes(Dense().encode(_one_client(theta)))
    return int(total)
