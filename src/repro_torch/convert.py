"""Weights across the frameworks: the port keeps the reference's layouts
(NHWC images, HWIO convs, ``x @ W`` dense weights, ``blocks`` lists), so
carrying a parameter tree across is a plain transfer through numpy.

``params_from_numpy`` accepts any tree of array-likes (numpy arrays, or
anything ``numpy.asarray`` converts).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def params_from_numpy(tree, device):
    """Tree of array-likes -> tree of tensors on ``device``."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(params):
    """Tree of tensors -> tree of numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
