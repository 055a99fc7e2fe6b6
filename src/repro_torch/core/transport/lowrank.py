"""Low-rank codecs: factored U·s·Vᵀ on the wire (counterpart of
``repro/core/transport/lowrank.py``).

``lowrank_svd`` ships the truncated SVD factors themselves — r(m+n+1)
numbers per (m, n) matrix per client.  ``power_sketch`` is the
randomized range finder (Halko et al., 2011): a few power iterations and
thin QRs instead of a full SVD, r(m+n) numbers on the wire.  The SVD and
QR are ``torch.linalg`` (cuSOLVER on the card), as the reference calls
``jnp.linalg`` outside any Pallas kernel.

Both compress a leaf whose per-client shape (``leaf.shape[1:]``: the
codecs take cohort-stacked leaves) has ``ndim >= 2`` and both trailing
dims above the rank; leading dims are a batch of matrices (a conv kernel
(3, 3, Cin, Cout) is a 3x3 batch of Cin x Cout matrices).  Everything
else passes through dense.

Server-side, ``accumulate_leaf`` contracts the w-scaled factors through
one merged (m, B·r) x (B·r, n) GEMM (``kernels/fused_agg/ops.py``) — the
dense per-client reconstructions never exist — and ``sq_norms_leaf``
uses the r x r gram trick.  ``wire_dtype="bf16"`` ships the factors (and
dense passthrough leaves) in bf16.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.transport.base import (
    Codec, LeafMsg, TransportConfig, WIRE_DTYPES, dense_leaf, register_codec,
    validate_wire_dtype,
)
from repro_torch.kernels.fused_agg import ops as fused_ops

OMEGA_SEED = 0xC0DEC


def _compressible(leaf, rank: int) -> bool:
    """The reference's rule on one client's shape (the leaf is stacked)."""
    shape = leaf.shape[1:]
    return len(shape) >= 2 and shape[-1] > rank and shape[-2] > rank


def _factor_dtype(leaf_dtype, wire_dtype: str):
    """Factors ship in the leaf dtype, capped by the wire dtype."""
    dt = WIRE_DTYPES[wire_dtype]
    return leaf_dtype if dt is None else dt


def _gram_sq_norms(lhs, rhs):
    """(B,) squared Frobenius norms of sum-factored lhs @ rhs per client
    via the r x r gram trick: ||L R||^2 = <LᵀL, R Rᵀ>."""
    gl = torch.einsum("...mr,...ms->...rs", lhs, lhs)
    gr = torch.einsum("...rn,...sn->...rs", rhs, rhs)
    per = torch.sum(gl * gr, dim=(-2, -1))
    return torch.sum(per.reshape(per.shape[0], -1), dim=-1)


def _svd(a):
    """Thin SVD of a batch of matrices.  A matrix holding a non-finite
    value gets NaN factors, as LAPACK returns them to the reference, where
    ``torch.linalg.svd`` would raise (a low-rank AdamW second moment has
    negative entries, so the next round's sqrt makes NaN)."""
    finite = torch.isfinite(a).all(dim=-1, keepdim=True).all(
        dim=-2, keepdim=True)
    u, s, vt = torch.linalg.svd(torch.where(finite, a, 0.0),
                                full_matrices=False)
    nan = torch.full((), float("nan"), device=a.device)
    return (torch.where(finite, u, nan),
            torch.where(finite[..., 0], s, nan),
            torch.where(finite, vt, nan))


def sketch_omega(n: int, rank: int, device):
    """The fixed (n, rank) Gaussian test matrix every client projects
    through.  Drawn once per (n, rank, device) from a CPU generator seeded
    with ``OMEGA_SEED`` and moved to ``device``, so GPU and CPU runs share
    it.  (The reference draws it from ``jax.random.key(0xC0DEC)``: other
    bits, the same distribution.)"""
    return _omega(n, rank, torch.device(device))


@functools.lru_cache(maxsize=None)
def _omega(n: int, rank: int, device: torch.device):
    gen = torch.Generator().manual_seed(OMEGA_SEED)
    return torch.randn((n, rank), generator=gen).to(device)


class LowRankSVD(Codec):
    name = "lowrank_svd"
    lossless = False

    def __init__(self, rank: int = 8, wire_dtype: str = "f32"):
        self.rank = rank
        self.wire_dtype = validate_wire_dtype(wire_dtype)

    def encode_leaf(self, leaf) -> LeafMsg:
        if not _compressible(leaf, self.rank):
            return dense_leaf(leaf, self.wire_dtype)
        u, s, vt = _svd(leaf.to(torch.float32))
        r = self.rank
        wd = _factor_dtype(leaf.dtype, self.wire_dtype)
        parts = {"u": u[..., :, :r].to(wd), "s": s[..., :r].to(wd),
                 "vt": vt[..., :r, :].to(wd)}
        return LeafMsg("lowrank", tuple(leaf.shape), leaf.dtype, parts)

    def decode_leaf(self, msg: LeafMsg):
        if msg.kind == "dense":
            return super().decode_leaf(msg)
        u = msg.parts["u"].to(torch.float32)
        s = msg.parts["s"].to(torch.float32)
        vt = msg.parts["vt"].to(torch.float32)
        return ((u * s[..., None, :]) @ vt).to(msg.dtype)

    def accumulate_leaf(self, msgs: LeafMsg, weights, carry=None):
        if msgs.kind == "dense":
            return super().accumulate_leaf(msgs, weights, carry=carry)
        out = fused_ops.lowrank_accumulate(
            msgs.parts["u"], msgs.parts["s"], msgs.parts["vt"], weights)
        return out if carry is None else carry + out

    def sq_norms_leaf(self, msgs: LeafMsg):
        if msgs.kind == "dense":
            return super().sq_norms_leaf(msgs)
        u = msgs.parts["u"].to(torch.float32)
        s = msgs.parts["s"].to(torch.float32)
        vt = msgs.parts["vt"].to(torch.float32)
        return _gram_sq_norms(u * s[..., None, :], vt)


class PowerSketch(Codec):
    name = "power_sketch"
    lossless = False

    def __init__(self, rank: int = 8, iters: int = 2,
                 wire_dtype: str = "f32"):
        self.rank = rank
        self.iters = iters
        self.wire_dtype = validate_wire_dtype(wire_dtype)

    def encode_leaf(self, leaf) -> LeafMsg:
        if not _compressible(leaf, self.rank):
            return dense_leaf(leaf, self.wire_dtype)
        a = leaf.to(torch.float32)
        at = a.transpose(-1, -2)
        # fixed sketch: every client projects through the same Omega
        omega = sketch_omega(a.shape[-1], self.rank, a.device)
        q, _ = torch.linalg.qr(a @ omega)            # (..., m, r)
        # subspace iteration, re-orthonormalized each half-step (Halko et
        # al. Alg. 4.4), as the reference runs it
        for _ in range(self.iters):
            z, _ = torch.linalg.qr(at @ q)
            q, _ = torch.linalg.qr(a @ z)
        b = q.transpose(-1, -2) @ a                  # (..., r, n)
        wd = _factor_dtype(leaf.dtype, self.wire_dtype)
        return LeafMsg("sketch", tuple(leaf.shape), leaf.dtype,
                       {"q": q.to(wd), "b": b.to(wd)})

    def decode_leaf(self, msg: LeafMsg):
        if msg.kind == "dense":
            return super().decode_leaf(msg)
        q = msg.parts["q"].to(torch.float32)
        b = msg.parts["b"].to(torch.float32)
        return (q @ b).to(msg.dtype)

    def accumulate_leaf(self, msgs: LeafMsg, weights, carry=None):
        if msgs.kind == "dense":
            return super().accumulate_leaf(msgs, weights, carry=carry)
        out = fused_ops.sketch_accumulate(msgs.parts["q"], msgs.parts["b"],
                                          weights)
        return out if carry is None else carry + out

    def sq_norms_leaf(self, msgs: LeafMsg):
        if msgs.kind == "dense":
            return super().sq_norms_leaf(msgs)
        return _gram_sq_norms(msgs.parts["q"].to(torch.float32),
                              msgs.parts["b"].to(torch.float32))


@register_codec("lowrank_svd")
def _make_lowrank(cfg: TransportConfig) -> LowRankSVD:
    return LowRankSVD(rank=cfg.rank, wire_dtype=cfg.wire_dtype)


# legacy AlgorithmSpec.upload token for the *_light variants
register_codec("svd")(_make_lowrank)


@register_codec("power_sketch")
def _make_sketch(cfg: TransportConfig) -> PowerSketch:
    return PowerSketch(rank=cfg.rank, iters=cfg.sketch_iters,
                       wire_dtype=cfg.wire_dtype)
