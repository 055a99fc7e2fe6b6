"""Synthetic datasets (numpy only), copied from ``repro/data/synth.py`` so
the port generates the reference's data bit for bit from the same seed.

* ``make_image_classification`` — gaussian-mixture "CIFAR-like" images with
  class-dependent means: a stand-in for CIFAR-100/Tiny-ImageNet.
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
