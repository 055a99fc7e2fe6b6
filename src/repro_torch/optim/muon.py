"""Muon (Alg. 6/7) in PyTorch — counterpart of ``repro/optim/muon.py``:
momentum orthogonalised by Newton–Schulz iterations.

Theta = {m} (the momentum is the alignable preconditioner state).  Hidden
matrices (``matrix_mask``; 3-D/4-D stacked tensors as batched matrices,
HWIO convs flattened by ``as_matrix``) take the orthogonalised momentum,
scaled by sqrt(max(1, rows/cols)) of the per-client matrix view; the
other leaves take an Adam fallback through the ``adam_moments`` kernel.
State is masked: ``m`` exists only on matrix leaves, ``am``/``av`` only
on the others.  ``weight_decay`` is added to the direction and
``state_dtype`` is the momentum's storage type; the orthogonalisation
runs in f32.

Trees may carry ``lead`` leading batch dims (the cohort-stacked client
axis).  One update orthogonalises every matrix leaf of every client in
one ``newton_schulz_group`` call (three grouped ``matmul_fused`` calls a
Newton–Schulz step), so a ViT-Tiny step is 15 ``matmul_fused`` launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ns_ortho.ops import newton_schulz_group
from repro_torch.kernels.soap_rotate.kernel import adam_moments
from repro_torch.optim.api import LocalOptimizer, as_matrix, matrix_mask
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_get, tree_map, tree_map_with_path,
)


def make(b1: float = 0.9, ns_steps: int = 5, weight_decay: float = 0.0,
         adam_b1: float = 0.9, adam_b2: float = 0.95,
         adam_eps: float = 1e-8, state_dtype=torch.float32
         ) -> LocalOptimizer:

    def init(params, lead: int = 0):
        mask = matrix_mask(params, lead)
        mom = tree_map(
            lambda p, im: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device) if im else None,
            params, mask)
        adam = tree_map(
            lambda p, im: None if im else torch.zeros(
                p.shape, dtype=torch.float32, device=p.device),
            params, mask)
        return {"m": mom, "am": adam, "av": adam}

    def update(grads, state, params, step: int, lead: int = 0,
               extras=None):
        del extras  # Muon takes no per-step inputs
        mask = matrix_mask(params, lead)
        out = {}
        mats = []            # (path, matrix view, orig shape) of matrix leaves
        for path, p in tree_flatten_with_path(params):
            g = tree_get(grads, path).to(torch.float32)
            if tree_get(mask, path):
                mm = tree_get(state["m"], path)
                m_new = (b1 * mm.to(torch.float32)
                         + (1 - b1) * g).to(state_dtype)
                mat, orig = as_matrix(m_new.to(torch.float32), lead)
                mats.append((path, mat, orig))
                out[path] = [None, m_new, None, None]
            else:
                d, am, av = adam_moments(
                    g, tree_get(state["am"], path),
                    tree_get(state["av"], path), b1=adam_b1, b2=adam_b2,
                    eps=adam_eps, step=step)
                out[path] = [d, None, am, av]
        us = newton_schulz_group([mat for _, mat, _ in mats],
                                 steps=ns_steps)
        for (path, mat, orig), u in zip(mats, us):
            rows, cols = mat.shape[-2], mat.shape[-1]
            u = u * math.sqrt(max(1.0, rows / cols))
            out[path][0] = u.reshape(orig) if orig is not None else u

        def leaf(path, p):
            d = out[path][0]
            if weight_decay:
                d = d + weight_decay * p.to(torch.float32)
            return d

        direction = tree_map_with_path(leaf, params)
        new_state = {
            name: tree_map_with_path(lambda path, _: out[path][i + 1], params)
            for i, name in enumerate(("m", "am", "av"))}
        return direction, new_state

    def get_precond(state):
        return {"m": state["m"]}

    def set_precond(state, theta):
        # a per-client theta broadcasts over the state's leading client axis
        def leaf(mm, th):
            return th.to(mm.dtype).expand(mm.shape)
        return dict(state, m=tree_map(leaf, state["m"], theta["m"]))

    return LocalOptimizer("muon", init, update, get_precond, set_precond,
                          precond_multiplier=1.0)
