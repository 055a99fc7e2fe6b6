"""Client partitioners (numpy only), copied from ``repro/data/partition.py``
so the port splits clients bit for bit as the reference does.

``dirichlet_partition`` (Hsu et al. 2019) is the paper's severity control:
smaller alpha => more severe label skew (Dir-0.1, Dir-0.05 in the tables).
``shard_partition`` is the pathological label split of McMahan et al.
2017, ``quantity_partition`` label-IID clients of Dirichlet-skewed sizes,
and ``iid_partition`` the uniform control.  Each returns a list of
``n_clients`` index arrays covering every sample exactly once and is
deterministic in ``seed``.

Population scale adds the lazy form: ``ClientIndexMap`` maps a client id
to its sample indices on demand, and ``stream_dirichlet_map`` derives each
client's Dirichlet label mixture from ``SeedSequence((seed, tag,
client_id))`` alone, so a 10^6-client partition costs nothing until a
client is staged and a client's data does not depend on the population
size around it.  Streamed clients view the sample pool with replacement.
"""
from __future__ import annotations

import threading
import warnings
from collections import OrderedDict
from typing import Callable

import numpy as np

# domain-separation tag for streamed per-client partition draws
_STREAM_TAG = 0x5D1B


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


def shard_partition(labels: np.ndarray, n_clients: int,
                    shards_per_client: int = 2, seed: int = 0):
    """Pathological label split: sort by label, deal shards to clients.

    With ``shards_per_client`` small each client sees only a handful of
    classes — the classic extreme non-IID setting of McMahan et al. 2017.
    """
    if shards_per_client < 1:
        raise ValueError(
            f"shards_per_client must be >= 1, got {shards_per_client}")
    labels = np.asarray(labels)
    n_shards = n_clients * shards_per_client
    if n_shards > len(labels):
        raise ValueError(
            f"shard_partition is infeasible: {n_shards} shards for "
            f"{len(labels)} samples")
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, n_shards)
    deal = rng.permutation(n_shards)
    parts = []
    for i in range(n_clients):
        own = deal[i * shards_per_client:(i + 1) * shards_per_client]
        p = np.concatenate([shards[s] for s in own])
        rng.shuffle(p)
        parts.append(p)
    return parts


def quantity_partition(n_samples: int, n_clients: int, alpha: float = 0.5,
                       seed: int = 0, min_size: int = 1):
    """Quantity skew: label-IID clients with Dirichlet(alpha)-skewed sizes."""
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    if n_clients * min_size > n_samples:
        raise ValueError(
            f"quantity_partition is infeasible: n_clients={n_clients} x "
            f"min_size={min_size} needs {n_clients * min_size} samples but "
            f"only {n_samples} are available")
    rng = np.random.default_rng(seed)
    props = rng.dirichlet(np.full(n_clients, alpha))
    spare = n_samples - n_clients * min_size
    cuts = (np.cumsum(props) * spare).astype(int)[:-1]
    sizes = np.diff(np.concatenate([[0], cuts, [spare]])) + min_size
    idx = rng.permutation(n_samples)
    return np.split(idx, np.cumsum(sizes)[:-1])


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
    """Summary of one partition: sizes and (with labels) label-skew TV.
    A ``ClientIndexMap`` is probed, not enumerated
    (``ClientIndexMap.sample_stats``)."""
    if isinstance(parts, ClientIndexMap):
        return parts.sample_stats(labels)
    sizes = [int(len(p)) for p in parts]
    stats = {"n_clients": len(parts), "n_samples": int(sum(sizes)),
             "min_size": min(sizes), "max_size": max(sizes),
             "mean_size": float(np.mean(sizes))}
    if labels is not None:
        stats["label_tv"] = heterogeneity_stat(parts, labels)
    return stats


class ClientIndexMap:
    """Lazy client-id -> sample-index mapping: ``map[client_id]`` derives
    that client's indices from a pure function of the id, with a small LRU
    cache for hot clients (the current cohort).  Thread-safe: the
    pipeline's stager threads query it concurrently."""

    def __init__(self, n_clients: int, fn: Callable[[int], np.ndarray],
                 cache_size: int = 4096):
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {n_clients}")
        self.n_clients = int(n_clients)
        self._fn = fn
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cache_size = int(cache_size)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self.n_clients

    def __getitem__(self, client_id) -> np.ndarray:
        cid = int(client_id)
        if not 0 <= cid < self.n_clients:
            raise IndexError(
                f"client id {cid} outside id space [0, {self.n_clients})")
        with self._lock:
            hit = self._cache.get(cid)
            if hit is not None:
                self._cache.move_to_end(cid)
                return hit
        idx = np.asarray(self._fn(cid), dtype=np.int64)
        with self._lock:
            self._cache[cid] = idx
            if len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return idx

    client_indices = __getitem__

    def sample_stats(self, labels=None, probe: int = 64) -> dict:
        """Partition stats from ``probe`` evenly spaced clients, flagged
        ``lazy: True`` with the probe count."""
        ids = np.unique(np.linspace(
            0, self.n_clients - 1, min(probe, self.n_clients)).astype(int))
        stats = partition_stats([self[c] for c in ids], labels)
        stats.update(n_clients=self.n_clients, lazy=True,
                     probed_clients=int(len(ids)))
        return stats


def stream_dirichlet_indices(class_indices, client_id: int, alpha: float,
                             samples_per_client: int, seed: int = 0):
    """One streamed client's sample indices, derived from the id alone:
    a Dirichlet(alpha) label mixture, ``samples_per_client`` split across
    classes multinomially, that many indices per class with replacement."""
    rng = np.random.default_rng(
        np.random.SeedSequence((seed, _STREAM_TAG, int(client_id))))
    n_classes = len(class_indices)
    props = rng.dirichlet(np.full(n_classes, alpha))
    counts = rng.multinomial(samples_per_client, props)
    picks = [rng.choice(class_indices[c], size=int(k), replace=True)
             for c, k in enumerate(counts) if k > 0]
    idx = np.concatenate(picks) if picks else np.empty(0, np.int64)
    rng.shuffle(idx)
    return idx


def stream_dirichlet_map(labels: np.ndarray, n_clients: int, alpha: float,
                         samples_per_client: int = 64,
                         seed: int = 0) -> ClientIndexMap:
    """Lazy Dirichlet label-skew partition over an arbitrary id space:
    per-class pools are built once, each client's slice on demand."""
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    if samples_per_client < 1:
        raise ValueError(
            f"samples_per_client must be >= 1, got {samples_per_client}")
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    class_indices = [np.where(labels == c)[0] for c in range(n_classes)]
    empty = [c for c, ix in enumerate(class_indices) if len(ix) == 0]
    if empty:
        raise ValueError(
            f"stream_dirichlet_map needs every class populated; classes "
            f"{empty} have no samples")
    return ClientIndexMap(
        n_clients,
        lambda cid: stream_dirichlet_indices(
            class_indices, cid, alpha, samples_per_client, seed))
