"""SOAP and Muon for a cohort of clients, in plain PyTorch float32.

SOAP (Vyas et al., 2024; the paper's Alg. 4): Kronecker factors
L = EMA[G G^T], R = EMA[G^T G]; every ``precond_freq`` local steps the
eigenbases are refreshed by one power iteration and a QR,
Q_L = qr(L Q_L).Q; Adam runs on Q_L^T G Q_R and its direction is rotated
back, Q_L N Q_R^T.  A side wider than ``max_precond_dim`` keeps the
identity.  Theta (what FedPAC aligns and aggregates) is {L, R}.

Muon (Jordan et al., 2024; Alg. 6): momentum m = b1 m + (1 - b1) g,
orthogonalised by five quintic Newton-Schulz steps of a matrix divided by
its Frobenius norm (wide orientation), scaled by sqrt(max(1, rows/cols)).
Theta is {m}.

Leaves that are not hidden matrices take Adam with the optimizer's
fallback settings.  Every leaf carries the cohort's clients on a leading
axis; which leaves are matrices is decided on the per-client shape, and
stacked leaves (clients, [layers,] m, n) are batches of matrices.
"""
from __future__ import annotations

import math

import torch

from fedbench.reference.common import adam, is_hidden_matrix

NS_COEFFS = (3.4445, -4.7750, 2.0315)


class Soap:
    def __init__(self, prec, *, b1=0.95, b2=0.95, eps=1e-8, precond_freq=10,
                 max_precond_dim=8192, adam_b1=0.9, adam_b2=0.999):
        self.prec = prec
        self.b1, self.b2, self.eps = b1, b2, eps
        self.freq, self.max_dim = precond_freq, max_precond_dim
        self.adam_b1, self.adam_b2 = adam_b1, adam_b2

    def init(self, params):
        state = {}
        for k, p in params.items():
            if not is_hidden_matrix(k, p.shape[1:]):
                state[k] = {"m": torch.zeros_like(p),
                            "v": torch.zeros_like(p)}
                continue
            *batch, m, n = p.shape
            st = {"M": torch.zeros_like(p), "V": torch.zeros_like(p)}
            for side, dim in (("L", m), ("R", n)):
                if dim <= self.max_dim:
                    st[side] = p.new_zeros((*batch, dim, dim))
                    st["Q" + side] = torch.eye(dim, device=p.device).expand(
                        *batch, dim, dim).clone()
            state[k] = st
        return state

    def set_theta(self, state, theta):
        """Alignment: every client's L, R from the global Theta."""
        for key, t in theta.items():
            k, side = key.rsplit(".", 1)
            state[k][side] = t.expand_as(state[k][side]).clone()

    def theta(self, state):
        return {f"{k}.{side}": st[side] for k, st in state.items()
                for side in ("L", "R") if side in st}

    def direction(self, grads, state, step: int):
        mm, b2 = self.prec.mm, self.b2
        out = {}
        for k, g in grads.items():
            st = state[k]
            if "M" not in st:
                out[k], st["m"], st["v"] = adam(
                    g, st["m"], st["v"], b1=self.adam_b1, b2=self.adam_b2,
                    eps=1e-8, step=step)
                continue
            gt = g.transpose(-1, -2)
            if "L" in st:
                st["L"] = (1 - b2) * mm(g, gt) + b2 * st["L"]
            if "R" in st:
                st["R"] = (1 - b2) * mm(gt, g) + b2 * st["R"]
            if step % self.freq == 0:
                for side in ("L", "R"):
                    if side in st:
                        st["Q" + side] = torch.linalg.qr(
                            mm(st[side], st["Q" + side]))[0]
            rot = g
            if "L" in st:
                rot = mm(st["QL"].transpose(-1, -2), rot)
            if "R" in st:
                rot = mm(rot, st["QR"])
            n, st["M"], st["V"] = adam(rot, st["M"], st["V"], b1=self.b1,
                                       b2=b2, eps=self.eps, step=step)
            if "L" in st:
                n = mm(st["QL"], n)
            if "R" in st:
                n = mm(n, st["QR"].transpose(-1, -2))
            out[k] = n
        return out


class Muon:
    def __init__(self, prec, *, b1=0.9, ns_steps=5, adam_b1=0.9,
                 adam_b2=0.95, adam_eps=1e-8):
        self.prec = prec
        self.b1, self.steps = b1, ns_steps
        self.adam_b1, self.adam_b2, self.adam_eps = adam_b1, adam_b2, adam_eps

    def init(self, params):
        return {k: ({"mom": torch.zeros_like(p)}
                    if is_hidden_matrix(k, p.shape[1:])
                    else {"m": torch.zeros_like(p), "v": torch.zeros_like(p)})
                for k, p in params.items()}

    def set_theta(self, state, theta):
        """Alignment: every client's momentum from the global Theta."""
        for key, t in theta.items():
            st = state[key.rsplit(".", 1)[0]]
            st["mom"] = t.expand_as(st["mom"]).clone()

    def theta(self, state):
        return {f"{k}.m": st["mom"] for k, st in state.items()
                if "mom" in st}

    def orthogonalise(self, x):
        mm = self.prec.mm
        a, b, c = NS_COEFFS
        tall = x.shape[-2] > x.shape[-1]
        if tall:
            x = x.transpose(-1, -2)
        x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
                 + 1e-7)
        for _ in range(self.steps):
            aa = mm(x, x.transpose(-1, -2))
            x = a * x + mm(b * aa + c * mm(aa, aa), x)
        return x.transpose(-1, -2) if tall else x

    def direction(self, grads, state, step: int):
        out = {}
        for k, g in grads.items():
            st = state[k]
            if "mom" not in st:
                out[k], st["m"], st["v"] = adam(
                    g, st["m"], st["v"], b1=self.adam_b1, b2=self.adam_b2,
                    eps=self.adam_eps, step=step)
                continue
            st["mom"] = self.b1 * st["mom"] + (1 - self.b1) * g
            rows, cols = g.shape[-2], g.shape[-1]
            out[k] = self.orthogonalise(st["mom"]) * math.sqrt(
                max(1.0, rows / cols))
        return out


OPTIMIZERS = {"soap": Soap, "muon": Muon}
