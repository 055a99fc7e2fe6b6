"""Client partitioners (numpy only), copied from ``repro/data/partition.py``
so the port splits clients bit for bit as the reference does.

``dirichlet_partition`` (Hsu et al. 2019) is the paper's severity control:
smaller alpha => more severe label skew (Dir-0.1, Dir-0.05 in the tables).
``iid_partition`` is the uniform control.  Both return a list of
``n_clients`` index arrays covering every sample exactly once and are
deterministic in ``seed``.  The shard, quantity and streamed kinds are not
ported yet.
"""
from __future__ import annotations

import warnings

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2,
                        max_retries: int = 20):
    """Returns list of index arrays, one per client.

    Every sample is assigned to exactly one client; per-class proportions are
    drawn from Dirichlet(alpha).  Degenerate draws that leave some client
    below ``min_size`` are retried with a softened alpha (x1.5 each time) at
    most ``max_retries`` times; softening is reported with a
    ``RuntimeWarning`` naming the effective alpha actually used, and an
    infeasible request (or retry exhaustion) raises ``ValueError``.
    """
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    if n_clients * min_size > len(labels):
        raise ValueError(
            f"dirichlet_partition is infeasible: n_clients={n_clients} x "
            f"min_size={min_size} needs {n_clients * min_size} samples but "
            f"only {len(labels)} are available")
    n_classes = int(labels.max()) + 1
    requested = alpha
    for attempt in range(max_retries + 1):
        idx_per_client = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[i].append(part)
        parts = [np.concatenate(p) if p else np.empty(0, np.int64)
                 for p in idx_per_client]
        if min(len(p) for p in parts) >= min_size:
            break
        if attempt < max_retries:  # degenerate draw; soften and retry
            alpha = alpha * 1.5
    else:
        raise ValueError(
            f"dirichlet_partition gave up after {max_retries} retries: "
            f"alpha softened {requested:g} -> {alpha:g} without every "
            f"client reaching min_size={min_size} ({len(labels)} samples, "
            f"{n_clients} clients) — lower min_size/n_clients or raise "
            "alpha")
    if alpha != requested:
        warnings.warn(
            f"dirichlet_partition: degenerate draws at alpha={requested:g}; "
            f"effective alpha={alpha:g} after softening retries",
            RuntimeWarning, stacklevel=2)
    for p in parts:
        rng.shuffle(p)
    return parts


def iid_partition(n_samples: int, n_clients: int, seed: int = 0):
    """Uniform random split of ``n_samples`` indices into ``n_clients``."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_samples)
    return np.array_split(idx, n_clients)


def heterogeneity_stat(parts, labels, n_classes=None) -> float:
    """Mean total-variation distance between client label dists and global."""
    labels = np.asarray(labels)
    n_classes = n_classes or int(labels.max()) + 1
    global_p = np.bincount(labels, minlength=n_classes) / len(labels)
    tvs = []
    for p in parts:
        if len(p) == 0:
            continue
        cp = np.bincount(labels[p], minlength=n_classes) / len(p)
        tvs.append(0.5 * np.abs(cp - global_p).sum())
    return float(np.mean(tvs))


def partition_stats(parts, labels=None) -> dict:
    """Summary of one partition: sizes and (with labels) label-skew TV."""
    sizes = [int(len(p)) for p in parts]
    stats = {"n_clients": len(parts), "n_samples": int(sum(sizes)),
             "min_size": min(sizes), "max_size": max(sizes),
             "mean_size": float(np.mean(sizes))}
    if labels is not None:
        stats["label_tv"] = heterogeneity_stat(parts, labels)
    return stats
