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


def tree_get(tree, path):
    """The subtree at ``path``, a key tuple of ``tree_flatten_with_path``."""
    for k in path:
        tree = tree[k]
    return tree


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


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order) in
    place of its leaves."""
    by_path = dict(zip((p for p, _ in tree_flatten_with_path(tree)), leaves))
    return tree_map_with_path(lambda p, _: by_path[p], tree)


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


def tree_dot(a, b):
    """sum over corresponding leaves of <a, b> (the reference's ``vdot``)."""
    return sum(torch.sum(x * y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# ------------------------------------------------ leaf-wise arithmetic

def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(s, a, b):
    """s*a + b, leaf-wise."""
    return tree_map(lambda x, y: s * x + y, a, b)


def tree_lerp(a, b, t):
    """(1-t)*a + t*b, leaf-wise."""
    return tree_map(lambda x, y: (1.0 - t) * x + t * y, a, b)


def tree_mean(trees):
    """Mean of a list of trees (same structure), summed in list order."""
    acc = trees[0]
    for t in trees[1:]:
        acc = tree_add(acc, t)
    return tree_scale(acc, 1.0 / len(trees))


def tree_stack_mean(tree):
    """Mean over the leading (client) axis of every leaf."""
    return tree_map(lambda x: torch.mean(x, dim=0), tree)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_size(a) -> int:
    return sum(x.numel() for x in tree_leaves(a))


def tree_bytes(a) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(a))


def tree_cast(a, dtype):
    """Floating leaves to ``dtype``; integer and bool leaves unchanged."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, a)


def global_norm(a):
    return torch.sqrt(tree_norm_sq(a))
