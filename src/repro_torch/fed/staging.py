"""Batch staging (counterpart of ``repro/fed/staging.py``).

``client_batch_fn(cid, rng)`` yields one local minibatch of host (numpy)
arrays; a cohort's K per-step batches for S clients stack on the host to
leading (S, K, ...) axes and cross to the device once per leaf.  Draws
happen client by client, K each, from the shared generator — the
reference's order.  The async runtime stages one client a dispatch
(``stage_client_batches``) with a leading axis of 1, so its local update
runs the same stacked path at S=1.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def stage_cohort_batches(client_batch_fn, cohort, local_steps: int, rng,
                         device):
    """A cohort's batches as device tensors with leading (S, K, ...) axes."""
    per_client = []
    for cid in cohort:
        steps = [client_batch_fn(int(cid), rng) for _ in range(local_steps)]
        per_client.append(tree_map(lambda *xs: np.stack(xs), *steps))
    stacked = tree_map(lambda *xs: np.stack(xs), *per_client)
    return tree_map(lambda x: torch.from_numpy(x).to(device), stacked)


def stage_client_batches(client_batch_fn, cid: int, local_steps: int, rng,
                         device):
    """One client's K batches as device tensors with leading (1, K, ...)
    axes, drawn as the reference's ``stage_client_batches`` draws them."""
    return stage_cohort_batches(client_batch_fn, [cid], local_steps, rng,
                                device)
