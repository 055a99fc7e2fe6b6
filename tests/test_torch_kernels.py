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
  * mixed f32/bf16/f16 operands: the f32 bound above on the operands'
    f32 values, plus one ulp of a 2-byte output (both sides round
    products that differ in the last f32 bits).
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
from repro_torch.kernels import grouped
from repro_torch.kernels.ns_ortho import kernel as nsk
from repro_torch.kernels.ns_ortho.kernel import matmul_fused, matmul_fused_group
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


@pytest.mark.parametrize("dtypes", ["bfloat16,float32,bfloat16",
                                    "float32,bfloat16,float16",
                                    "float16,float16,float32"])
def test_matmul_fused_plain_matches_pallas_mixed_dtypes(dtypes):
    """lhs, rhs and aux each in its own dtype, as the reference's kernel
    takes them (it casts them to f32 inside its body): the output in
    lhs's dtype on both sides, the values within the f32 bound plus one
    ulp of that dtype.  A ragged (130, 257, 50) product."""
    m, k, n = 130, 257, 50
    names = dtypes.split(",")
    r = _rng("mmmix", dtypes)
    xs = [r.standard_normal(s).astype(np.float32)
          for s in ((m, k), (k, n), (m, n))]
    js = [jnp.asarray(x, getattr(jnp, d)) for x, d in zip(xs, names)]
    want = jax_matmul_fused(*js, alpha=0.5, beta=-2.0, interpret=True)
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, d)) for j, d in zip(js, names)]
    got = matmul_fused(*ts, alpha=0.5, beta=-2.0)
    assert got.dtype == getattr(torch, names[0])
    assert want.dtype == getattr(jnp, names[0])
    f32 = [np.asarray(j.astype(jnp.float32)) for j in js]
    want32 = np.asarray(want.astype(jnp.float32))
    ulp = float(torch.finfo(got.dtype).eps) if names[0] != "float32" else 0
    tol = _dot_bound(*f32, 0.5, -2.0) + ulp * np.abs(want32) + 1e-7 * bool(
        ulp)
    assert np.all(np.abs(got.float().numpy() - want32) <= tol)


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


# ------------------------------------------------------ matmul_fused_group

# Per leaf (S, m, n): ViT-like at narrow width and the CNN's leaves (27 x 8
# has 108-byte rows); the (27, 8) leaf's Q_R is the batch-stride-0
# ``expand``ed identity SOAP starts from.
GROUP_LEAVES = [(2, 24, 72), (2, 24, 24), (2, 72, 24), (2, 27, 8),
                (2, 8, 16), (2, 16, 32)]


def _leaf_forms(s, m, n):
    """SOAP's six products for one leaf as numpy (lhs, rhs, aux, alpha,
    beta) plus the torch operands as the kernel sees them (transposes as
    strided views, the identity Q as an ``expand``)."""
    r = _rng("group", s, m, n)
    g = r.standard_normal((s, m, n)).astype(np.float32)
    ql = np.stack([_qr(r.standard_normal((m, m))) for _ in range(s)])
    qr = (np.broadcast_to(np.eye(n, dtype=np.float32), (s, n, n))
          if (m, n) == (27, 8)
          else np.stack([_qr(r.standard_normal((n, n))) for _ in range(s)]))
    lf, rf = (r.standard_normal((s, d, d)).astype(np.float32) for d in (m, n))
    nn_ = r.standard_normal((s, m, n)).astype(np.float32)
    tg, tql, tn = _t(g), _t(ql), _t(nn_)
    tqr = (torch.eye(n).expand(s, n, n) if (m, n) == (27, 8) else _t(qr))
    tr = lambda x: np.swapaxes(x, -1, -2)     # noqa: E731
    forms_np = [(g, tr(g), lf, 0.05, 0.95), (tr(g), g, rf, 0.05, 0.95),
                (tr(ql), g, None, 1.0, 0.0), (g, qr, None, 1.0, 0.0),
                (ql, nn_, nn_ * 0.5, -0.7, 1.5), (nn_, tr(qr), None, 2.0, 0.0)]
    forms_t = [(tg, tg.transpose(1, 2), _t(lf), 0.05, 0.95),
               (tg.transpose(1, 2), tg, _t(rf), 0.05, 0.95),
               (tql.transpose(1, 2), tg, None, 1.0, 0.0),
               (tg, tqr, None, 1.0, 0.0),
               (tql, tn, _t(nn_ * 0.5), -0.7, 1.5),
               (tn, tqr.transpose(1, 2), None, 2.0, 0.0)]
    return forms_np, forms_t


@pytest.fixture(scope="module")
def mixed_group():
    """One ``matmul_fused_group`` call over every form of every leaf."""
    forms = [_leaf_forms(*leaf) for leaf in GROUP_LEAVES]
    problems = [p for _, ft in forms for p in ft]
    outs = matmul_fused_group(problems)
    per_leaf, i = [], 0
    for fn, ft in forms:
        per_leaf.append((fn, outs[i:i + len(ft)]))
        i += len(ft)
    return per_leaf


@pytest.mark.parametrize("leaf", range(len(GROUP_LEAVES)),
                         ids=[f"{m}x{n}" for _, m, n in GROUP_LEAVES])
def test_matmul_fused_group_plain_matches_pallas_per_problem(mixed_group,
                                                             leaf):
    forms_np, outs = mixed_group[leaf]
    for (lhs, rhs, aux, alpha, beta), got in zip(forms_np, outs):
        assert tuple(got.shape) == (lhs.shape[0], lhs.shape[1],
                                    rhs.shape[2])
        for b in range(lhs.shape[0]):
            x = None if aux is None else aux[b]
            want = jax_matmul_fused(
                jnp.asarray(lhs[b]), jnp.asarray(rhs[b]),
                None if x is None else jnp.asarray(x), alpha=alpha,
                beta=beta, interpret=True)
            bound = _dot_bound(lhs[b], rhs[b], x, alpha, beta)
            assert np.all(np.abs(got[b].numpy() - np.asarray(want)) <= bound)


def test_matmul_fused_group_of_one_is_matmul_fused():
    _, forms = _leaf_forms(2, 24, 72)
    for lhs, rhs, aux, alpha, beta in forms:
        (got,) = matmul_fused_group([(lhs, rhs, aux, alpha, beta)])
        assert torch.equal(got, matmul_fused(lhs, rhs, aux, alpha=alpha,
                                             beta=beta))
    assert matmul_fused_group([]) == []


def _row(batch, m, n, k, *, ptr=4096):
    lhs, rhs = torch.empty((batch, m, k)), torch.empty((batch, k, n))
    return nsk.problem_row(lhs, rhs, None, 1.0, 0.0, ptr)


def test_group_tables_tile_counts_prefix_offsets_and_k_order():
    tile = (128, 64)
    shapes = [(5, 192, 576, 192), (2, 27, 27, 8), (5, 768, 768, 192),
              (5, 192, 192, 768), (3, 0, 10, 50), (1, 130, 65, 576)]
    (table, idx), = nsk.group_tables([_row(*s) for s in shapes], tile)
    # longest k first, stable; the empty problem (m = 0) is dropped
    assert idx == [3, 5, 0, 2, 1]
    recs = table[nsk.HEADER_BYTES:].view(nsk.PROBLEM)[:len(idx)]
    want_tiles = {0: 5 * 2 * 9, 1: 2 * 1 * 1, 2: 5 * 6 * 12, 3: 5 * 2 * 3,
                  5: 1 * 2 * 2}
    assert [(r["tiles_m"], r["tiles_n"]) for r in recs] == [
        (-(-shapes[i][1] // 128), -(-shapes[i][2] // 64)) for i in idx]
    counts = [want_tiles[i] for i in idx]
    assert recs["tile_start"].tolist() == list(np.cumsum(counts) - counts)
    assert table[:8].view(np.int32).tolist() == [len(idx), sum(counts)]
    assert recs["k"].tolist() == [shapes[i][3] for i in idx]
    assert table.nbytes == nsk.TABLE_BYTES


def test_group_tables_split_at_the_parameter_limit():
    assert nsk.MAX_PROBLEMS == (32764 - 16) // 144 == 227
    assert nsk.PROBLEM.itemsize == 144
    assert nsk.TABLE_BYTES <= 32764
    rows = [_row(1, 8, 8, 4 + i) for i in range(2 * nsk.MAX_PROBLEMS + 5)]
    tables = nsk.group_tables(rows)
    assert [len(i) for _, i in tables] == [nsk.MAX_PROBLEMS,
                                           nsk.MAX_PROBLEMS, 5]
    assert sorted(i for _, idx in tables for i in idx) == list(range(
        len(rows)))
    small = nsk.group_tables(rows[:7], max_problems=3)
    assert [len(i) for _, i in small] == [3, 3, 1]
    for table, idx in small:
        recs = table[nsk.HEADER_BYTES:].view(nsk.PROBLEM)
        assert table[:4].view(np.int32)[0] == len(idx)
        assert recs["tile_start"][0] == 0


@pytest.mark.parametrize("case,want", [
    # (ptr, (sb, sx, sk), ext_x, k, batch) -> (kc, vec)
    ("row-major lhs, 16 B rows", ((4096, (64, 8, 1), 8, 8, 2), (True, True))),
    ("CNN 27-wide rows (108 B)", ((4096, (729, 27, 1), 27, 27, 2),
                                  (True, False))),
    ("k-major (transposed view)", ((4096, (64, 1, 8), 8, 8, 2),
                                   (False, True))),
    ("misaligned base", ((4100, (64, 8, 1), 8, 8, 2), (True, False))),
    ("identity expand, stride 0", ((4096, (0, 16, 1), 16, 16, 5),
                                   (True, True))),
    ("odd batch stride", ((4096, (66, 8, 1), 8, 8, 2), (True, False))),
    ("odd batch stride, batch 1", ((4096, (66, 8, 1), 8, 8, 1),
                                   (True, True))),
    ("no unit stride", ((4096, (64, 2, 16), 4, 4, 1), (False, False))),
    ("single row", ((4096, (27, 27, 1), 1, 27, 1), (True, True))),
])
def test_operand_flags(case, want):
    assert nsk.operand_flags(*want[0]) == want[1], case


def test_problem_row_flags_for_soap_forms():
    """G G^T and G^T G read G through its strides: k-contiguous on both
    sides for L, m/n-contiguous for R; a (27, 27) Q takes 4-byte copies;
    an output 27 wide, or an aux with 108-byte rows, takes 4-byte
    accesses."""
    g = torch.empty((2, 27, 8))
    q = torch.empty((2, 27, 27))
    flags = lambda row: row[20]                    # noqa: E731
    assert flags(nsk.problem_row(g, g.transpose(1, 2), None, 1, 0, 0)) == (
        nsk.A_KC | nsk.B_KC | nsk.A_VEC | nsk.B_VEC)
    assert flags(nsk.problem_row(g.transpose(1, 2), g, None, 1, 0, 0)) == (
        nsk.A_VEC | nsk.B_VEC | nsk.O_VEC)
    assert flags(nsk.problem_row(q.transpose(1, 2), g, None, 1, 0, 0)) == (
        nsk.B_VEC | nsk.O_VEC)
    assert flags(nsk.problem_row(q, g, None, 1, 0, 0)) == (
        nsk.A_KC | nsk.B_VEC | nsk.O_VEC)
    assert flags(nsk.problem_row(q, g, torch.empty((2, 27, 8)), 1, 0, 0)) == (
        nsk.A_KC | nsk.B_VEC | nsk.O_VEC)
    assert flags(nsk.problem_row(q, g, g[:, :, :].transpose(1, 2)
                                 .transpose(1, 2), 1, 0, 0)) & nsk.O_VEC
    assert not flags(nsk.problem_row(q, q, q, 1, 0, 0)) & nsk.O_VEC


def test_arena_offsets_are_128_byte_aligned():
    offsets, _, total, _ = grouped.arena_layout(((5,), (32,), (33,), (0,),
                                                 (1,)))
    assert offsets[0].tolist() == [0, 32, 64, 128, 128]
    assert total == 160


# --------------------------------------------------------- phased SOAP step

def _soap_per_leaf(g, st, step, *, b1, b2, eps, precond_freq):
    """One matrix leaf's SOAP step composed leaf by leaf: the EMAs through
    ``matmul_fused``, the refresh, then ``soap_rotated_update``."""
    new = dict(st)
    gt = g.transpose(-1, -2)
    if "L" in st:
        new["L"] = matmul_fused(g, gt, st["L"], alpha=1 - b2, beta=b2)
    if "R" in st:
        new["R"] = matmul_fused(gt, g, st["R"], alpha=1 - b2, beta=b2)
    if step % precond_freq == 0:
        for q, f in (("QL", "L"), ("QR", "R")):
            if q in st:
                new[q] = torch.linalg.qr(torch.matmul(new[f], st[q]))[0]
    d, new["M"], new["V"] = soap_rotated_update(
        g, new.get("QL"), new.get("QR"), st["M"], st["V"], b1=b1, b2=b2,
        eps=eps, step=step)
    return d, new


@pytest.mark.parametrize("max_precond_dim", [8192, 15],
                         ids=["two-sided", "one-sided"])
def test_phased_soap_update_equals_per_leaf_composition(max_precond_dim):
    """The phased update (one grouped product per phase over all leaves)
    equals the per-leaf composition bit for bit on the CPU, for 2-D, conv
    and 3-D expert leaves stacked over 3 clients; at 15, (12, 20) keeps
    only L and the (18, 8) conv view only R."""
    from repro_torch.optim import api, soap
    from repro_torch.utils.tree import tree_flatten_with_path
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, precond_freq=2)
    opt = soap.make(max_precond_dim=max_precond_dim, **kw)
    r = _rng("phased", max_precond_dim)
    shapes = {"w": (12, 20), "stem": (3, 3, 2, 8), "experts": (2, 10, 12),
              "bias": (20,)}
    params = {k: _t(r.standard_normal((3, *s))) for k, s in shapes.items()}
    state = opt.init(params, lead=1)
    ref = {k: dict(state["mat"][k]) for k in ("w", "stem", "experts")}
    sides = {k: set(v) for k, v in ref.items()}
    if max_precond_dim == 15:
        assert sides["w"] == {"L", "QL", "M", "V"}
        assert sides["stem"] == {"R", "QR", "M", "V"}
    assert sides["experts"] == {"L", "QL", "R", "QR", "M", "V"}
    for step in range(3):
        grads = {k: _t(r.standard_normal(p.shape)) for k, p in params.items()}
        d, state = opt.update(grads, state, params, step, lead=1)
        for k in ref:
            g, shape = api.as_matrix(grads[k], lead=1)
            want_d, ref[k] = _soap_per_leaf(g, ref[k], step, **kw)
            if shape is not None:
                want_d = want_d.reshape(shape)
            assert torch.equal(d[k], want_d), (k, step)
            for key, x in ref[k].items():
                assert torch.equal(state["mat"][k][key], x), (k, key, step)
    assert len(tree_flatten_with_path(d)) == len(shapes)
