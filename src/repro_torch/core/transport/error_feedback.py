"""Error feedback for lossy upload codecs (EF-SGD, Karimireddy et al. 2019)
— counterpart of ``repro/core/transport/error_feedback.py``.

A lossy delta codec introduces a bias: what the server decodes is not
what the client computed.  Error feedback carries the residual

    e_i' = (delta_i + e_i) - decode(encode(delta_i + e_i))

as per-client persistent state, adding it back before the next round's
encode — the compression error is delayed, not lost.  The residuals are
stacked ``(N, ...)`` f32 on the run's device and threaded through the
round as declared client state (``core.algorithms.EF_STATE``).

Unlike the reference's functional ``.at[].set``, ``ef_scatter`` writes
the cohort's rows in place: the stacked state is as large as N copies of
the model, and a functional scatter would hold two of it.
"""
from __future__ import annotations

import torch

from repro_torch.core.transport.base import Codec
from repro_torch.utils.tree import tree_map


def ef_init(params, n_clients: int):
    """Stacked (N, ...) f32 residuals, zero at round 0."""
    return tree_map(lambda p: torch.zeros((n_clients, *p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def ef_view(state, cid):
    """The residuals of client ``cid`` (an index, or a (S,) index tensor
    for the cohort's stacked rows; a gather copies them)."""
    return tree_map(lambda r: r[cid], state)


def ef_scatter(state, cohort, new_residuals):
    """Write the cohort's refreshed residuals back (leading cohort axis),
    in place; returns ``state``."""
    def put(a, u):
        a[cohort] = u.to(a.dtype)
        return a
    return tree_map(put, state, new_residuals)


def encode_with_feedback(codec: Codec, tree, residual=None):
    """Encode ``tree`` (error-compensated when ``residual`` is given).

    Returns (msg, decoded, new_residual); decoded and new_residual are
    None when no residual was passed.  The residual accumulates in f32,
    but what goes to the codec keeps ``tree``'s dtypes, so the wire format
    and its byte count do not change with error feedback on.
    """
    if residual is None:
        return codec.encode(tree), None, None
    src32 = tree_map(lambda t, r: t.to(torch.float32) + r, tree, residual)
    src = tree_map(lambda s, t: s.to(t.dtype), src32, tree)
    msg = codec.encode(src)
    decoded = codec.decode(msg)
    new_residual = tree_map(lambda s, d: s - d.to(torch.float32), src32,
                            decoded)
    return msg, decoded, new_residual
