"""Preconditioner drift metric (Definition 1) — counterpart of
``repro/core/drift.py``.

Delta_D = (1/S) sum_i || Theta_i - mean_j Theta_j ||^2 over client-stacked
Theta trees (leading axis S), summed over leaves in reference order.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves


def drift_metric(thetas):
    """Scalar Frobenius drift over all Theta leaves. thetas: stacked (S,...)."""
    total = None
    for leaf in tree_leaves(thetas):
        x = leaf.to(torch.float32)
        c = x - x.mean(dim=0, keepdim=True)
        term = torch.mean(torch.sum(c.reshape(c.shape[0], -1) ** 2, dim=-1))
        total = term if total is None else total + term
    return total if total is not None else torch.zeros(())
