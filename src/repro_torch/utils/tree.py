"""Pytree helpers over nested dicts/lists/tuples of tensors.

Leaves are ordered as ``jax.tree`` orders them — dict keys sorted, lists
and tuples in order, ``None`` dropped (an empty subtree) — so reductions
summed leaf by leaf (``tree_norm_sq``, ``core.drift.drift_metric``) add in
the reference's order.
"""
from __future__ import annotations

import torch


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_flatten_with_path(tree, path=()):
    """[(path, leaf)] in reference leaf order; ``path`` is a key tuple."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for k, sub in kids:
        out.extend(tree_flatten_with_path(sub, path + (k,)))
    return out


def tree_leaves(tree):
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over corresponding leaves; ``rest`` trees share ``tree``'s
    structure.  ``None`` subtrees map to ``None`` unless ``is_leaf`` claims
    them."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest], is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, v, *[r[i] for r in rest], is_leaf=is_leaf)
            for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over every leaf; ``path`` is a key tuple."""
    if tree is None:
        return None
    if _children(tree) is None:
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return type(tree)(tree_map_with_path(fn, v, path + (i,))
                      for i, v in enumerate(tree))


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


def client_weighted_sum(tree, weights):
    """sum_i w_i x_i over the leading (client) axis of every leaf, in f32:
    one contraction of the weight vector against the client axis."""
    w = weights.to(torch.float32)
    return tree_map(
        lambda x: torch.tensordot(w, x.to(torch.float32), dims=([0], [0])),
        tree)


def tree_norm_sq(tree):
    return sum(torch.sum(x * x) for x in tree_leaves(tree))
