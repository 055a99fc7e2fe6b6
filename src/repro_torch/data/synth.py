"""Synthetic datasets (numpy only), copied from ``repro/data/synth.py`` so
the port generates the reference's data bit for bit from the same seed.

* ``make_image_classification`` — gaussian-mixture "CIFAR-like" images with
  class-dependent means: a stand-in for CIFAR-100/Tiny-ImageNet.
* ``make_lm_corpus`` — per-client token streams with client-specific Zipf
  parameters + topic offsets: a stand-in for Dirichlet-partitioned C4.
* ``make_lm_topic_corpus`` — topic-labelled documents with topic-specific
  Zipf unigram distributions: the label-bearing LM source that lets the
  scenario API drive heterogeneity through the same partitioners
  (Dirichlet/shard/quantity/IID over topic labels) as the vision tasks.
* ``lm_batches`` — (steps, batch, seq_len) token/label windows of a stream.
"""
from __future__ import annotations

import numpy as np


def make_image_classification(n: int, *, image_size: int = 16, channels: int = 3,
                              n_classes: int = 10, noise: float = 0.8,
                              seed: int = 0):
    """Returns (images (n, H, W, C) float32, labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    d = image_size * image_size * channels
    protos = rng.normal(0, 1, (n_classes, d)).astype(np.float32)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    x = protos[labels] + noise * rng.normal(0, 1, (n, d)).astype(np.float32)
    return x.reshape(n, image_size, image_size, channels), labels


def make_lm_corpus(n_clients: int, tokens_per_client: int, *, vocab: int = 512,
                   hetero: float = 1.0, seed: int = 0):
    """Per-client token streams with client-specific unigram distributions.

    ``hetero`` in [0,1]: 0 => identical zipf for all clients (IID);
    1 => each client's zipf is shifted by a random permutation over a
    client-specific "topic" block (strongly non-IID).
    """
    if not 0.0 <= hetero <= 1.0:
        raise ValueError(f"hetero must be in [0, 1], got {hetero}")
    rng = np.random.default_rng(seed)
    base = 1.0 / (np.arange(1, vocab + 1) ** 1.1)
    streams = []
    for i in range(n_clients):
        perm = np.arange(vocab)
        if hetero > 0:
            shift = rng.permutation(vocab)
            keep = rng.random(vocab) > hetero
            perm = np.where(keep, perm, shift)
        p = base[perm]
        p = p / p.sum()
        streams.append(rng.choice(vocab, size=tokens_per_client, p=p)
                       .astype(np.int32))
    return streams


def make_lm_topic_corpus(n_docs: int, tokens_per_doc: int, *, vocab: int = 512,
                         n_topics: int = 8, seed: int = 0):
    """Topic-labelled documents: (docs (n_docs, tokens_per_doc) int32,
    topics (n_docs,) int32).

    Each topic owns a Zipf unigram distribution over a topic-specific vocab
    permutation; a document's tokens are drawn from its topic's
    distribution.  Partitioning documents by topic label with the standard
    partitioners reproduces Dirichlet-partitioned-corpus heterogeneity.
    """
    if n_docs < 1 or tokens_per_doc < 1:
        raise ValueError(
            f"need n_docs >= 1 and tokens_per_doc >= 1, got "
            f"n_docs={n_docs}, tokens_per_doc={tokens_per_doc}")
    if vocab < 2 or n_topics < 1:
        raise ValueError(
            f"need vocab >= 2 and n_topics >= 1, got vocab={vocab}, "
            f"n_topics={n_topics}")
    rng = np.random.default_rng(seed)
    base = 1.0 / (np.arange(1, vocab + 1) ** 1.1)
    topic_ps = []
    for _ in range(n_topics):
        p = base[rng.permutation(vocab)]
        topic_ps.append(p / p.sum())
    topics = rng.integers(0, n_topics, n_docs).astype(np.int32)
    docs = np.stack([rng.choice(vocab, size=tokens_per_doc, p=topic_ps[t])
                     for t in topics]).astype(np.int32)
    return docs, topics


def lm_batches(stream: np.ndarray, *, seq_len: int, batch: int, steps: int,
               seed: int = 0):
    """Sample (steps, batch, seq_len+1) windows -> tokens/labels pairs."""
    if seq_len < 1 or batch < 1 or steps < 1:
        raise ValueError(
            f"need seq_len/batch/steps >= 1, got seq_len={seq_len}, "
            f"batch={batch}, steps={steps}")
    if len(stream) <= seq_len + 1:
        raise ValueError(
            f"lm_batches needs a stream longer than seq_len + 1 = "
            f"{seq_len + 1} tokens to sample a window, got {len(stream)}")
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(stream) - seq_len - 1, (steps, batch))
    idx = starts[..., None] + np.arange(seq_len + 1)
    windows = stream[idx]  # (steps, batch, seq+1)
    return windows[..., :-1], windows[..., 1:]
