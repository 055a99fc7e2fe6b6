"""The port's kernels (``repro_torch.kernels``) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the reference's pure-jnp math and against the Pallas
kernels in interpret mode (as tests/test_kernels.py runs them).
tests/test_torch_kernels_cuda.py holds each hand-written kernel against
its plain version on the card.

Tolerances:
  * f32 products: the classical dot-product bound |err| <= 2 (k+2) u
    sum_k |a||b| (u = 2^-24) elementwise — the two sides sum in different
    orders, each within (k+2) u of the exact value.
  * bf16 products: 6e-2 * sqrt(k), the reference test's bound (both sides
    round the same f32 sum to bf16; one bf16 ulp apart at most).
  * adam_moments: 1e-6 absolute on m', v' (the same f32 expression) and
    1e-5 relative on n (a division and a square root, each rounded).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ns_ortho.kernel import matmul_fused as jax_matmul_fused
from repro.kernels.soap_rotate import ops as jax_sr_ops, ref as jax_sr_ref
from repro.kernels.soap_rotate.kernel import adam_moments as jax_adam_moments
from repro_torch.kernels.ns_ortho.kernel import matmul_fused
from repro_torch.kernels.soap_rotate.kernel import adam_moments
from repro_torch.kernels.soap_rotate.ops import soap_rotated_update

MM_SHAPES = [(8, 8, 8), (128, 128, 128), (64, 200, 96), (130, 257, 50),
             (256, 64, 384)]
U = 2.0 ** -24


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _dot_bound(lhs, rhs, aux, alpha, beta):
    """Elementwise f32 bound for two differently-ordered evaluations of
    alpha * lhs @ rhs + beta * aux."""
    k = lhs.shape[-1]
    mag = abs(alpha) * (np.abs(lhs) @ np.abs(rhs))
    if aux is not None:
        mag = mag + abs(beta) * np.abs(aux)
    return 2 * (k + 2) * U * mag + 1e-30


def _qr(x):
    q, _ = np.linalg.qr(x)
    return q.astype(np.float32)


# ------------------------------------------------------------ matmul_fused

@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_matmul_fused_plain_matches_pallas_and_ref_f32(m, k, n):
    r = _rng("mm", m, k, n)
    lhs, rhs, aux = (r.standard_normal(s).astype(np.float32)
                     for s in ((m, k), (k, n), (m, n)))
    want_ref = 0.5 * (jnp.asarray(lhs) @ jnp.asarray(rhs)) - 2.0 * aux
    want_pal = jax_matmul_fused(jnp.asarray(lhs), jnp.asarray(rhs),
                                jnp.asarray(aux), alpha=0.5, beta=-2.0,
                                interpret=True)
    got = matmul_fused(_t(lhs), _t(rhs), _t(aux), alpha=0.5, beta=-2.0)
    bound = _dot_bound(lhs, rhs, aux, 0.5, -2.0)
    for want in (want_ref, want_pal):
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_matmul_fused_plain_matches_pallas_bf16(m, k, n):
    r = _rng("mmbf", m, k, n)
    lhs, rhs, aux = (r.standard_normal(s).astype(np.float32)
                     for s in ((m, k), (k, n), (m, n)))
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (lhs, rhs, aux)]
    want = jax_matmul_fused(*jb, alpha=0.5, beta=-2.0, interpret=True)
    tb = [torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
          for x in jb]
    got = matmul_fused(*tb, alpha=0.5, beta=-2.0)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert err.max() < 6e-2 * max(1, k ** 0.5)


@pytest.mark.parametrize("transpose", ["none", "lhs", "rhs", "both"])
def test_matmul_fused_batched_strided_matches_pallas(transpose):
    """Batched (S, E, m, k) operands, transposes passed as views."""
    r = _rng("mmb", transpose)
    s, e, m, k, n = 3, 2, 24, 40, 16
    lhs = r.standard_normal((s, e, m, k)).astype(np.float32)
    rhs = r.standard_normal((s, e, k, n)).astype(np.float32)
    aux = r.standard_normal((s, e, m, n)).astype(np.float32)
    tl, tr = _t(lhs), _t(rhs)
    if transpose in ("lhs", "both"):
        tl = _t(np.swapaxes(lhs, -1, -2).copy()).transpose(-1, -2)
    if transpose in ("rhs", "both"):
        tr = _t(np.swapaxes(rhs, -1, -2).copy()).transpose(-1, -2)
    got = matmul_fused(tl, tr, _t(aux), alpha=0.7, beta=0.3).numpy()
    for i in range(s):
        for j in range(e):
            want = jax_matmul_fused(
                jnp.asarray(lhs[i, j]), jnp.asarray(rhs[i, j]),
                jnp.asarray(aux[i, j]), alpha=0.7, beta=0.3, interpret=True)
            bound = _dot_bound(lhs[i, j], rhs[i, j], aux[i, j], 0.7, 0.3)
            assert np.all(np.abs(got[i, j] - np.asarray(want)) <= bound)


def test_matmul_fused_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="shape mismatch"):
        matmul_fused(torch.ones(2, 3, 4), torch.ones(3, 4, 5))
    with pytest.raises(ValueError, match="aux shape"):
        matmul_fused(torch.ones(3, 4), torch.ones(4, 5), torch.ones(3, 4))


def test_cpu_tensors_never_launch_kernels():
    before = (matmul_fused.launches, adam_moments.launches)
    matmul_fused(torch.ones(4, 4), torch.ones(4, 4))
    adam_moments(torch.ones(7), torch.zeros(7), torch.zeros(7))
    assert (matmul_fused.launches, adam_moments.launches) == before


def test_unsupported_device_raises_instead_of_falling_back():
    meta = torch.ones(4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        matmul_fused(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        adam_moments(meta, meta, meta)


# ------------------------------------------------------------ adam_moments

@pytest.mark.parametrize("shape", [(40,), (128, 256), (3, 40, 50), (2048,)])
@pytest.mark.parametrize("step", [None, 0, 4])
def test_adam_moments_plain_matches_pallas(shape, step):
    r = _rng("adam", shape, step)
    g = r.standard_normal(shape).astype(np.float32)
    m = r.standard_normal(shape).astype(np.float32)
    v = r.uniform(size=shape).astype(np.float32)
    kw = dict(b1=0.9, b2=0.99, eps=1e-8)
    want = jax_adam_moments(jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
                            step=None if step is None else jnp.int32(step),
                            interpret=True, **kw)
    got = adam_moments(_t(g), _t(m), _t(v), step=step, **kw)
    n_w, m_w, v_w = (np.asarray(x) for x in want)
    n_g, m_g, v_g = (x.numpy() for x in got)
    assert np.abs(m_g - m_w).max() <= 1e-6
    assert np.abs(v_g - v_w).max() <= 1e-6
    assert np.all(np.abs(n_g - n_w) <= 1e-5 * np.maximum(1.0, np.abs(n_w)))


# ------------------------------------------------------- soap_rotated_update

def _soap_inputs(key, batch, m, n):
    r = _rng("soap", key, batch, m, n)
    g = r.standard_normal((*batch, m, n)).astype(np.float32)
    ql = np.stack([_qr(r.standard_normal((m, m)))
                   for _ in range(int(np.prod(batch)))]).reshape(*batch, m, m)
    qr = np.stack([_qr(r.standard_normal((n, n)))
                   for _ in range(int(np.prod(batch)))]).reshape(*batch, n, n)
    mm = r.standard_normal((*batch, m, n)).astype(np.float32)
    vv = r.uniform(size=(*batch, m, n)).astype(np.float32)
    return g, ql, qr, mm, vv


@pytest.mark.parametrize("m,n", [(16, 24), (128, 128), (100, 60)])
@pytest.mark.parametrize("step", [None, 2])
def test_soap_rotated_update_matches_ref_and_pallas(m, n, step):
    g, ql, qr, mm, vv = _soap_inputs("2d", (), m, n)
    jstep = None if step is None else jnp.int32(step)
    args = [jnp.asarray(x) for x in (g, ql, qr, mm, vv)]
    want_ref = jax_sr_ref.soap_rotated_update(*args, step=jstep)
    want_pal = jax_sr_ops.soap_rotated_update(*args, step=jstep,
                                              use_pallas=True, interpret=True)
    got = soap_rotated_update(*(_t(x) for x in (g, ql, qr, mm, vv)),
                              step=step)
    for want in (want_ref, want_pal):
        for w, o in zip(want, got):
            assert np.abs(np.asarray(w) - o.numpy()).max() < 5e-5


@pytest.mark.parametrize("side", ["both", "left", "right"])
def test_soap_rotated_update_batched_and_one_sided(side):
    """(S, m, n) batches against the reference per client; a missing side
    is the identity rotation."""
    s, m, n = 3, 20, 12
    g, ql, qr, mm, vv = _soap_inputs(side, (s,), m, n)
    if side == "left":
        qr = np.broadcast_to(np.eye(n, dtype=np.float32), (s, n, n))
    if side == "right":
        ql = np.broadcast_to(np.eye(m, dtype=np.float32), (s, m, m))
    got = soap_rotated_update(
        _t(g), None if side == "right" else _t(ql),
        None if side == "left" else _t(qr), _t(mm), _t(vv), step=1)
    for i in range(s):
        want = jax_sr_ref.soap_rotated_update(
            *(jnp.asarray(x[i]) for x in (g, ql, qr, mm, vv)),
            step=jnp.int32(1))
        for w, o in zip(want, got):
            assert np.abs(np.asarray(w) - o[i].numpy()).max() < 5e-5
