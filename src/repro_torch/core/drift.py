"""Preconditioner drift metric (Definition 1) — counterpart of
``repro/core/drift.py``.

Delta_D = (1/S) sum_i || Theta_i - mean_j Theta_j ||^2 over client-stacked
Theta trees (leading axis S), summed over leaves in reference order.
``drift_per_layer`` keeps the per-leaf breakdown the paper plots in
Fig. 3; ``spectral_drift`` the layer-wise spectral norm of
(Theta_i - mean) for matrix-valued states (the Fig. 3 SOAP variant).
"""
from __future__ import annotations

import torch

from repro_torch.sharding.ops import is_dtensor
from repro_torch.utils.tree import (
    path_str, tree_flatten_with_path, tree_leaves,
)


def drift_metric(thetas, device):
    """Scalar Frobenius drift over all Theta leaves. thetas: stacked (S,...).
    A Theta with no leaves (SGD without momentum) has drift 0, on the
    run's ``device``."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for leaf in tree_leaves(thetas):
        total = total + _leaf_drift(leaf)
    return total


def _centered(leaf):
    x = leaf.to(torch.float32)
    return x - x.mean(dim=0, keepdim=True)


def _leaf_drift(leaf):
    c = _centered(leaf)
    if is_dtensor(c):
        # the dry-run's DTensors: flattening a leaf sharded on two dims
        # gives a placement DTensor's ops do not take; sum over the dims
        return torch.mean(torch.sum(c ** 2, dim=tuple(range(1, c.ndim))))
    return torch.mean(torch.sum(c.reshape(c.shape[0], -1) ** 2, dim=-1))


def drift_per_layer(thetas) -> dict:
    """Dict path -> per-leaf drift (Fig. 3 layer-wise view)."""
    return {path_str(path): _leaf_drift(leaf)
            for path, leaf in tree_flatten_with_path(thetas)}


def spectral_drift(thetas) -> dict:
    """Mean spectral norm ||Theta_i - mean||_2 over clients, per matrix
    leaf (SOAP's L/R factors: the paper's Fig. 3 measurement).  Leaves
    with fewer than 2 dims per client are skipped."""
    out = {}
    for path, leaf in tree_flatten_with_path(thetas):
        if leaf.dim() < 3:  # (S, m, n) at minimum
            continue
        c = _centered(leaf)
        mats = c.reshape(-1, c.shape[-2], c.shape[-1])
        sn = torch.linalg.matrix_norm(mats, ord=2)
        out[path_str(path)] = torch.mean(sn)
    return out
