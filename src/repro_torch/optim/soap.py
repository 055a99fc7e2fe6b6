"""SOAP (Alg. 4/5) in PyTorch — counterpart of ``repro/optim/soap.py``.

Shampoo-style Kronecker factors L = EMA[G G^T], R = EMA[G^T G]; eigenbasis
(Q_L, Q_R) refreshed by one QR power iteration every ``precond_freq``
steps; Adam run in the rotated basis.  Theta = {L, R}.

Matrices with a dimension above ``max_precond_dim`` go one-sided (identity
on that side); 3-D expert tensors are batched matrices; non-matrix leaves
fall back to Adam.  Trees may carry ``lead`` leading batch dims (the
cohort-stacked client axis): every matrix op is batched over them, so one
update steps all clients at once.

Every matrix leaf's work goes through the port's kernels: the L/R EMAs
through ``matmul_fused``'s epilogue form (alpha = 1-b2, beta = b2,
aux = L), the rotated step through ``soap_rotated_update`` (matmul_fused +
adam_moments), and the Adam fallback through ``adam_moments``.  The
refresh product P @ Q and the QR stay library calls, as the reference
leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ns_ortho.kernel import matmul_fused
from repro_torch.kernels.soap_rotate.kernel import adam_moments
from repro_torch.kernels.soap_rotate.ops import soap_rotated_update
from repro_torch.optim.api import LocalOptimizer, as_matrix, matrix_mask
from repro_torch.utils.tree import tree_map, tree_map_with_path


def _eig_refresh(p_mat, q):
    """Eigenvectors(P, Q): one power iteration + QR (the paper's Alg. 4)."""
    q_new, _ = torch.linalg.qr(torch.matmul(p_mat, q))
    return q_new


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _is_state_leaf(x):
    return x is None or (isinstance(x, dict) and "M" in x)


def make(b1: float = 0.95, b2: float = 0.95, eps: float = 1e-8,
         precond_freq: int = 10, max_precond_dim: int = 8192,
         weight_decay: float = 0.0, adam_b1: float = 0.9,
         adam_b2: float = 0.999) -> LocalOptimizer:

    def _leaf_state(p, is_mat, lead):
        if not is_mat:
            return None
        pm, _ = as_matrix(p, lead)
        m, n = pm.shape[-2], pm.shape[-1]
        batch = tuple(pm.shape[:-2])
        kw = dict(device=p.device, dtype=torch.float32)
        st = {}
        if m <= max_precond_dim:
            st["L"] = torch.zeros((*batch, m, m), **kw)
            st["QL"] = torch.eye(m, **kw).expand(*batch, m, m)
        if n <= max_precond_dim:
            st["R"] = torch.zeros((*batch, n, n), **kw)
            st["QR"] = torch.eye(n, **kw).expand(*batch, n, n)
        st["M"] = torch.zeros(pm.shape, **kw)
        st["V"] = torch.zeros(pm.shape, **kw)
        return st

    def init(params, lead: int = 0):
        mask = matrix_mask(params, lead)
        mat = tree_map(lambda p, im: _leaf_state(p, im, lead), params, mask)
        # Adam fallback moments only for non-matrix leaves
        adam = tree_map(
            lambda p, im: None if im else torch.zeros(
                p.shape, device=p.device, dtype=torch.float32), params, mask)
        return {"mat": mat, "am": adam, "av": adam}

    def _matrix_update(g, st, p, step, lead):
        g, orig_shape = as_matrix(g.to(torch.float32), lead)
        gt = g.transpose(-1, -2)
        new = dict(st)
        if "L" in st:
            new["L"] = matmul_fused(g, gt, st["L"], alpha=1 - b2, beta=b2)
        if "R" in st:
            new["R"] = matmul_fused(gt, g, st["R"], alpha=1 - b2, beta=b2)
        if step % precond_freq == 0:
            if "QL" in st:
                new["QL"] = _eig_refresh(new["L"], st["QL"])
            if "QR" in st:
                new["QR"] = _eig_refresh(new["R"], st["QR"])
        # Bias-corrected Adam in the rotated basis (t = step + 1): moments
        # restart from zero every federated round
        d, new["M"], new["V"] = soap_rotated_update(
            g, new.get("QL"), new.get("QR"), st["M"], st["V"], b1=b1, b2=b2,
            eps=eps, step=step)
        if orig_shape is not None:
            d = d.reshape(orig_shape)
        if weight_decay:
            d = d + weight_decay * p.to(torch.float32)
        return d, new

    def update(grads, state, params, step: int, lead: int = 0):
        mask = matrix_mask(params, lead)
        out = {}

        def leaf(path, p):
            g = _get(grads, path)
            if _get(mask, path):
                d, st = _matrix_update(g, _get(state["mat"], path), p, step,
                                       lead)
                out[path] = (st, None, None)
            else:
                d, am, av = adam_moments(
                    g, _get(state["am"], path), _get(state["av"], path),
                    b1=adam_b1, b2=adam_b2, eps=1e-8, step=step)
                if weight_decay:
                    d = d + weight_decay * p.to(torch.float32)
                out[path] = (None, am, av)
            return d

        direction = tree_map_with_path(leaf, params)
        new_state = {
            name: tree_map_with_path(lambda path, _: out[path][i], params)
            for i, name in enumerate(("mat", "am", "av"))}
        return direction, new_state

    def get_precond(state):
        def leaf(st):
            if st is None:
                return None
            return {k: st[k] for k in ("L", "R") if k in st}
        return {"LR": tree_map(leaf, state["mat"], is_leaf=_is_state_leaf)}

    def set_precond(state, theta):
        # Alignment replaces the curvature statistics (Alg. 5 line 3); Q
        # re-derives from them at the next scheduled refresh.  A per-client
        # theta broadcasts over the state's leading client axis.
        def leaf(st, th):
            if st is None:
                return None
            new = dict(st)
            for k in ("L", "R"):
                if k in st and th is not None and k in th:
                    new[k] = th[k].to(st[k].dtype).expand(st[k].shape)
            return new

        mat = tree_map(leaf, state["mat"], theta["LR"], is_leaf=_is_state_leaf)
        return dict(state, mat=mat)

    return LocalOptimizer("soap", init, update, get_precond, set_precond)
