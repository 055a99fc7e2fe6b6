"""SOAP (Alg. 4/5) in PyTorch — counterpart of ``repro/optim/soap.py``.

Shampoo-style Kronecker factors L = EMA[G G^T], R = EMA[G^T G]; eigenbasis
(Q_L, Q_R) refreshed by one QR power iteration every ``precond_freq``
steps (``eig_method="qr"``, the paper's Alg. 4) or by Newton–Schulz
orthogonalisation of the same power-iteration product
(``eig_method="ns"``, matmuls only; other numerics, so an option and not
the default, as in the reference); Adam run in the rotated basis.
Theta = {L, R}.

``state_dtype`` (the reference's) stores L, R, Q_L and Q_R in that dtype
(bf16 halves the O(m^2 + n^2) state of a wide model); M, V and the Adam
fallback stay f32.  Every product and refresh reads f32 casts of the
stored factors and rounds its result back to ``state_dtype``, as the
reference does: ``matmul_fused`` takes f32 operands, so the casts come
before each grouped launch.

Matrices with a dimension above ``max_precond_dim`` go one-sided (identity
on that side); 3-D expert tensors are batched matrices; non-matrix leaves
fall back to Adam.  Trees may carry ``lead`` leading batch dims (the
cohort-stacked client axis): every matrix op is batched over them, so one
update steps all clients at once.

Every matrix leaf's work goes through the port's kernels, phase by phase
over all matrix leaves so each product phase is one grouped
``matmul_fused`` launch: the L/R EMAs (the epilogue form, alpha = 1-b2,
beta = b2, aux = L/R), then Q_L^T G, G Q_R, ``adam_moments`` per leaf, Q_L
N and N Q_R^T — the per-leaf math and order of ``soap_rotated_update``.  A
ViT-Tiny step is 5 launches of ``matmul_fused`` instead of 288.  The Adam
fallback goes through ``adam_moments``.  The refresh product P @ Q stays
a library call, as the reference leaves it to XLA; so does the QR.  The
``"ns"`` refresh orthogonalises every side of every matrix leaf in one
``newton_schulz_group`` call: 15 more ``matmul_fused`` launches a refresh.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ns_ortho.kernel import matmul_fused_group
from repro_torch.kernels.ns_ortho.ops import newton_schulz_group
from repro_torch.kernels.soap_rotate.kernel import adam_moments
from repro_torch.optim.api import LocalOptimizer, as_matrix, matrix_mask
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_get, tree_map, tree_map_with_path,
)


EIG_METHODS = ("qr", "ns")


def _eig_refresh(pairs, method: str):
    """Eigenvectors(P, Q) for every (P, Q) of ``pairs``: one power
    iteration, then QR (the paper's Alg. 4) matrix by matrix, or
    Newton–Schulz over all of them in one grouped call."""
    prods = [torch.matmul(p_mat, q) for p_mat, q in pairs]
    if method == "ns":
        return newton_schulz_group(prods)
    return [torch.linalg.qr(s)[0] for s in prods]


def _is_state_leaf(x):
    return x is None or (isinstance(x, dict) and "M" in x)


def make(b1: float = 0.95, b2: float = 0.95, eps: float = 1e-8,
         precond_freq: int = 10, max_precond_dim: int = 8192,
         weight_decay: float = 0.0, state_dtype=torch.float32,
         adam_b1: float = 0.9, adam_b2: float = 0.999,
         eig_method: str = "qr") -> LocalOptimizer:
    if eig_method not in EIG_METHODS:
        raise ValueError(f"eig_method must be one of {EIG_METHODS}, got "
                         f"{eig_method!r}")
    sd = getattr(torch, state_dtype) if isinstance(state_dtype, str) \
        else state_dtype
    f32 = torch.float32

    def _leaf_state(p, is_mat, lead):
        if not is_mat:
            return None
        pm, _ = as_matrix(p, lead)
        m, n = pm.shape[-2], pm.shape[-1]
        batch = tuple(pm.shape[:-2])
        kw = dict(device=p.device, dtype=sd)
        st = {}
        if m <= max_precond_dim:
            st["L"] = torch.zeros((*batch, m, m), **kw)
            st["QL"] = torch.eye(m, **kw).expand(*batch, m, m)
        if n <= max_precond_dim:
            st["R"] = torch.zeros((*batch, n, n), **kw)
            st["QR"] = torch.eye(n, **kw).expand(*batch, n, n)
        st["M"] = torch.zeros(pm.shape, device=p.device, dtype=f32)
        st["V"] = torch.zeros(pm.shape, device=p.device, dtype=f32)
        return st

    def init(params, lead: int = 0):
        mask = matrix_mask(params, lead)
        mat = tree_map(lambda p, im: _leaf_state(p, im, lead), params, mask)
        # Adam fallback moments only for non-matrix leaves
        adam = tree_map(
            lambda p, im: None if im else torch.zeros(
                p.shape, device=p.device, dtype=torch.float32), params, mask)
        return {"mat": mat, "am": adam, "av": adam}

    def _phase(xs, states, key, operands):
        """One grouped ``matmul_fused`` over the leaves whose state holds
        ``key``: ``operands(state[key], x) -> (lhs, rhs)``; the other
        leaves pass ``xs`` through (identity on a missing side)."""
        idx = [i for i, st in enumerate(states) if key in st]
        outs = matmul_fused_group([
            (*operands(states[i][key], xs[i]), None, 1.0, 0.0) for i in idx])
        xs = list(xs)
        for i, out in zip(idx, outs):
            xs[i] = out
        return xs

    def _matrix_updates(gs, states, step):
        """The matrix leaves' SOAP step, phase by phase over all leaves
        (one launch per product phase).  Per leaf the math and its order
        are ``soap_rotated_update``'s after the EMAs and the refresh.
        Stored factors are read as f32 casts and results rounded back to
        ``state_dtype`` (no copy at f32)."""
        new = [dict(st) for st in states]
        # 1. L/R EMAs: L' = (1-b2) G G^T + b2 L, R' = (1-b2) G^T G + b2 R
        problems, slots = [], []
        for i, (g, st) in enumerate(zip(gs, states)):
            gt = g.transpose(-1, -2)
            for key, lhs, rhs in (("L", g, gt), ("R", gt, g)):
                if key in st:
                    problems.append((lhs, rhs, st[key].to(f32), 1 - b2, b2))
                    slots.append((i, key))
        for (i, key), x in zip(slots, matmul_fused_group(problems)):
            new[i][key] = x.to(sd)
        # 2. the scheduled eigenbasis refresh, every side of every leaf
        if step % precond_freq == 0:
            sides = [(st, q, f) for st in new
                     for q, f in (("QL", "L"), ("QR", "R")) if q in st]
            qs = _eig_refresh([(st[f].to(f32), st[q].to(f32))
                               for st, q, f in sides], eig_method)
            for (st, q, _), q_new in zip(sides, qs):
                st[q] = q_new.to(sd)
        # the eigenbases as f32 operands of the four rotation phases
        qf = [{k: st[k].to(f32) for k in ("QL", "QR") if k in st}
              for st in new]
        # 3-4. G' = Q_L^T G Q_R
        rot = _phase(gs, qf, "QL", lambda q, g: (q.transpose(-1, -2), g))
        rot = _phase(rot, qf, "QR", lambda q, g: (g, q))
        # 5. bias-corrected Adam in the rotated basis (t = step + 1):
        #    moments restart from zero every federated round
        ns = []
        for g_rot, st in zip(rot, new):
            n, st["M"], st["V"] = adam_moments(
                g_rot, st["M"], st["V"], b1=b1, b2=b2, eps=eps, step=step)
            ns.append(n)
        # 6-7. D = Q_L N Q_R^T
        ds = _phase(ns, qf, "QL", lambda q, n: (q, n))
        ds = _phase(ds, qf, "QR", lambda q, n: (n, q.transpose(-1, -2)))
        return ds, new

    def update(grads, state, params, step: int, lead: int = 0,
               extras=None):
        del extras  # SOAP takes no per-step inputs
        mask = matrix_mask(params, lead)
        out = {}
        mats = []                        # (path, orig_shape) of matrix leaves
        gs, states = [], []
        for path, p in tree_flatten_with_path(params):
            g = tree_get(grads, path)
            if tree_get(mask, path):
                gm, orig_shape = as_matrix(g.to(torch.float32), lead)
                mats.append((path, orig_shape))
                gs.append(gm)
                states.append(tree_get(state["mat"], path))
            else:
                d, am, av = adam_moments(
                    g, tree_get(state["am"], path),
                    tree_get(state["av"], path),
                    b1=adam_b1, b2=adam_b2, eps=1e-8, step=step)
                out[path] = (d, None, am, av)
        ds, news = _matrix_updates(gs, states, step)
        for (path, orig_shape), d, st in zip(mats, ds, news):
            if orig_shape is not None:
                d = d.reshape(orig_shape)
            out[path] = (d, st, None, None)

        def leaf(path, p):
            d = out[path][0]
            if weight_decay:
                d = d + weight_decay * p.to(torch.float32)
            return d

        direction = tree_map_with_path(leaf, params)
        new_state = {
            name: tree_map_with_path(lambda path, _: out[path][i + 1], params)
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

    return LocalOptimizer("soap", init, update, get_precond, set_precond,
                          precond_multiplier=2.0)
