"""Unified local-optimizer API: the paper's (Theta, P_Theta) abstraction
(counterpart of ``repro/optim/api.py``).

Every optimizer is a ``LocalOptimizer`` of functions over param trees:

  init(params, lead=0)                             -> state
  update(grads, state, params, step, lead=0, extras=None)
                                                   -> (direction, state)
  get_precond(state)                               -> Theta
  set_precond(state, theta)                        -> state

``lead`` counts leading batch dims that every leaf carries in front of its
per-client shape — 1 for the cohort-stacked ``(S, ...)`` trees the round
engine steps all clients through at once.  Leaf classification
(``matrix_mask``) and the matrix view (``as_matrix``) always look at the
per-client shape, so a stacked HWIO conv is still a conv.  ``extras``
carries optional per-step inputs: Sophia's Hutchinson estimate
(``{"h_est": tree}``) on the steps that refresh it, when
``needs_hessian`` asks the client loop for one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.utils.tree import path_str, tree_map_with_path


@dataclasses.dataclass(frozen=True)
class LocalOptimizer:
    name: str
    init: Callable[..., Any]
    update: Callable[..., Any]
    get_precond: Callable[[Any], Any]
    set_precond: Callable[[Any, Any], Any]
    # True if the client loop must supply a Hutchinson diag-Hessian estimate
    needs_hessian: bool = False
    # Fraction/structure of Theta uploaded per round, for comm accounting
    precond_multiplier: float = 1.0


_NON_MATRIX_TOKENS = ("embed", "tok", "head", "norm", "bias", "scale",
                      "conv", "a_log", "lam", "cls", "pos", "dt_bias")


def is_hidden_matrix(path, shape) -> bool:
    """Hidden-layer weight (Muon/SOAP domain) by per-client ``shape``:
    excludes embeddings, heads, norms/biases/convs, degenerate matrices."""
    if len(shape) < 2:
        return False
    if shape[-1] < 8 or shape[-2] < 8:
        # degenerate matrices (cls tokens, tiny gates) -> Adam fallback
        if not (len(shape) == 4 and shape[0] <= 7):
            return False
    s = path_str(path).lower()
    return not any(tok in s for tok in _NON_MATRIX_TOKENS)


def as_matrix(x, lead: int = 0):
    """Canonical matrix view, decided on the per-client shape.

    2-D: as-is; 3-D (layers-or-experts, m, n): batched matrices; 4-D conv
    HWIO (small spatial dims): flattened to (k*k*c_in, c_out); other 4-D+:
    batch dims collapsed.  Leading ``lead`` dims are kept in front.
    Returns (mat, orig_shape_or_None).
    """
    head, per = tuple(x.shape[:lead]), tuple(x.shape[lead:])
    if len(per) <= 3:
        return x, None
    if len(per) == 4 and per[0] <= 7 and per[1] <= 7:
        return x.reshape(*head, -1, per[-1]), tuple(x.shape)
    return x.reshape(*head, -1, per[-2], per[-1]), tuple(x.shape)


def matrix_mask(params, lead: int = 0):
    """Tree of bools: which leaves get the matrix preconditioner."""
    return tree_map_with_path(
        lambda path, leaf: is_hidden_matrix(path, tuple(leaf.shape[lead:])),
        params)
