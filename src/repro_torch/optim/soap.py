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
fallback stay f32.  The arithmetic is the reference's: every product
reads the stored factors widened to f32 and accumulates in f32, and only
the stored factors are rounded to ``state_dtype``.  ``matmul_fused``
widens a bf16 or f16 operand itself, so the grouped launches read the
stored factors as they are (no f32 copy of L, R, Q_L or Q_R): the EMAs
write ``state_dtype`` factors from an f32 G, the rotations f32 results
from a ``state_dtype`` Q.  The refresh casts its inputs to f32, as the
reference does, for ``torch.matmul`` and the QR.

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
a library call, as the reference leaves it to XLA.  On the card the QR
refresh takes every side of every matrix leaf in one ``householder_qr``
launch at f32 state (at a narrower ``state_dtype`` in groups whose f32
products hold at most twice the largest: ``refresh_groups``), the
hand-written kernel overwriting the products with their Q's, where the
kernel takes the group (``householder_qr.kernel.takes``: its matrices
fit shared memory or fill the card).  Any other group, and every QR off
the card, goes side by side to ``sharding.ops.qr_q``: ``torch.linalg.qr``,
and on a DTensor, the dry-run's, on the replicated product.  The ``"ns"``
refresh orthogonalises every side of every matrix leaf in one
``newton_schulz_group`` call: one ``newton_schulz`` launch a refresh.
The refresh is traced as the ``soap_refresh`` span of the live tracer
(``obs.trace.current()``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.householder_qr.kernel import (
    householder_qr_group, takes_group,
)
from repro_torch.kernels.ns_ortho.kernel import matmul_fused_group
from repro_torch.kernels.ns_ortho.ops import newton_schulz_group
from repro_torch.kernels.soap_rotate.kernel import adam_moments
from repro_torch.obs.trace import current as current_tracer
from repro_torch.optim.api import LocalOptimizer, as_matrix, matrix_mask
from repro_torch.sharding.ops import is_dtensor, qr_q
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_get, tree_map, tree_map_with_path,
)


EIG_METHODS = ("qr", "ns")


def _on_kernel(qs) -> bool:
    """Whether the QR of the sides whose Q's are ``qs`` runs on the
    hand-written kernel: plain CUDA tensors, of a group it takes."""
    return bool(qs) and all(not is_dtensor(q) and q.device.type == "cuda"
                            for q in qs) and takes_group(qs)


def _eig_refresh(sides, method: str):
    """Eigenvectors(P, Q) of each side ``(state, Q key, P key)`` of
    ``sides``, P and Q in f32 as the reference's: one power iteration,
    then QR (the paper's Alg. 4) or Newton–Schulz; the new Q's in f32.
    Newton–Schulz, and a QR that the kernel takes (``_on_kernel``), run
    over all the products in one launch; the kernel overwrites each
    product, which takes the state's old Q's place as it is made.  Any
    other QR goes side by side through ``qr_q``, lazily: a side's product
    lives only for its own QR."""
    def product(st, q, f):
        return torch.matmul(st[f].to(torch.float32), st[q].to(torch.float32))

    if method == "ns":
        return newton_schulz_group([product(*side) for side in sides])
    if not _on_kernel([st[q] for st, q, _ in sides]):
        return (qr_q(product(*side)) for side in sides)
    prods = []
    for st, q, f in sides:
        prods.append(product(st, q, f))
        st[q] = prods[-1]
    return householder_qr_group(prods)


def refresh_groups(numels, whole: bool):
    """The sides (indices into ``numels``, each side's element count)
    that one QR refresh call takes together: all of them where ``whole``
    (f32 state: the QR overwrites the f32 products, which become the new
    Q's), else runs in order whose f32 products hold at most twice the
    largest side's, about what one product, its Q and the library's
    workspace held when every QR went to the library."""
    if whole or not numels:
        return [list(range(len(numels)))]
    budget = 2 * max(numels)
    groups, held = [[]], 0
    for i, k in enumerate(numels):
        if groups[-1] and held + k > budget:
            groups.append([])
            held = 0
        groups[-1].append(i)
        held += k
    return groups


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
        ``key``: ``operands(state[key], x) -> (lhs, rhs)``, the product in
        f32; the other leaves pass ``xs`` through (identity on a missing
        side)."""
        idx = [i for i, st in enumerate(states) if key in st]
        outs = matmul_fused_group([
            (*operands(states[i][key], xs[i]), None, 1.0, 0.0, f32)
            for i in idx])
        xs = list(xs)
        for i, out in zip(idx, outs):
            xs[i] = out
        return xs

    def _matrix_updates(gs, states, step):
        """The matrix leaves' SOAP step, phase by phase over all leaves
        (one launch per product phase).  Per leaf the math and its order
        are ``soap_rotated_update``'s after the EMAs and the refresh.
        Stored factors are read in ``state_dtype`` and widened by the
        kernel; the EMAs' results are written in it."""
        new = [dict(st) for st in states]
        # 1. L/R EMAs: L' = (1-b2) G G^T + b2 L, R' = (1-b2) G^T G + b2 R
        problems, slots = [], []
        for i, (g, st) in enumerate(zip(gs, states)):
            gt = g.transpose(-1, -2)
            for key, lhs, rhs in (("L", g, gt), ("R", gt, g)):
                if key in st:
                    problems.append((lhs, rhs, st[key], 1 - b2, b2, sd))
                    slots.append((i, key))
        for (i, key), out in zip(slots, matmul_fused_group(problems)):
            new[i][key] = out
        # 2. the scheduled eigenbasis refresh, every side of every leaf
        if step % precond_freq == 0:
            with current_tracer().span("soap_refresh"):
                sides = [(st, q, f) for st in new
                         for q, f in (("QL", "L"), ("QR", "R")) if q in st]
                groups = refresh_groups(
                    [st[q].numel() for st, q, _ in sides],
                    eig_method == "ns" or sd == f32)
                for idx in groups:
                    part = [sides[i] for i in idx]
                    qs = _eig_refresh(part, eig_method)
                    for (st, q, _), qn in zip(part, qs):
                        st[q] = qn.to(sd)
                    del qs       # a group's f32 Q's go before the next's

        # 3-4. G' = Q_L^T G Q_R
        rot = _phase(gs, new, "QL", lambda q, g: (q.transpose(-1, -2), g))
        rot = _phase(rot, new, "QR", lambda q, g: (g, q))
        # 5. bias-corrected Adam in the rotated basis (t = step + 1):
        #    moments restart from zero every federated round
        ns = [None] * len(new)
        for i, st in enumerate(new):
            ns[i], st["M"], st["V"] = adam_moments(
                rot[i], st["M"], st["V"], b1=b1, b2=b2, eps=eps, step=step)
        del rot      # each phase's outputs are views of one arena
        # 6-7. D = Q_L N Q_R^T
        ds = _phase(ns, new, "QL", lambda q, n: (q, n))
        del ns
        ds = _phase(ds, new, "QR", lambda q, n: (n, q.transpose(-1, -2)))
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
