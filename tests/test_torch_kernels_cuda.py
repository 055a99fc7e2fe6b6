"""The port's hand-written Hopper kernels against their plain PyTorch
versions, on the card.  Every test here is marked ``cuda`` and skips on a
host without a CUDA device; this file imports no JAX, so it runs on a GPU
host that has none:

    python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances:
  * matmul_fused (one product or a group): the classical dot-product
    bound |err| <= 2 (k+2) u (|alpha| sum_k |a||b| + |beta| |aux|)
    (u = 2^-24) elementwise — two f32 sums in different orders.  On bf16
    and f16 operands (each its own dtype) the kernel is held bitwise to
    itself on the operands' f32 casts (it widens them exactly and sums in
    the same order), its 2-byte outputs bitwise to that f32 result rounded
    by ``.to(dtype)``, and its f32 result within the bound above of the
    plain version on the casts.
  * adam_moments: 1e-6 max(1, |x|) on m', v' (the same expression, FMA
    contraction aside) and 1e-5 max(1, |n|) on n (a division and a square
    root, each rounded or approximated differently).
  * soap_rotated_update: 1e-4 max(1, |x|), the composition of the above.
  * sophia_update: 1e-6 max(1, |x|) on d and m' for one leaf (the same
    f32 expression, FMA contraction off in the kernel); inputs include
    h = 0 and clip-saturated entries.  The grouped form is held bitwise
    (NaN where the plain version has NaN) on a mixed list with NaN and
    +-inf, unaligned views and ragged sizes.
  * quantize (one leaf or a group): q and scale bitwise equal (inputs
    include exact k + 0.5 ties, all-zero blocks, ragged tails and views at
    a 4-byte offset); a block holding NaN or +-inf gets the plain
    version's NaN or inf scale (its codes, a NaN cast to int8, are not
    compared).
  * dequant_accumulate (one leaf or a group): 4 B u sum_i |w_i s_i q_i|
    per element; since the carry operand the kernel rounds each product
    and sum alone in client order, as the plain version does, and the
    carry tests hold it bitwise (carry or none, vectorized and ragged
    leaves, NaN in the carry).
  * newton_schulz_group (one launch of its own kernel): the output
    within 1e-4 of the plain version (f32 against f64 of the same
    iteration differs by <= 8.4e-7 at ViT-Tiny shapes; entries are
    <= 0.3), and two calls bitwise equal.
  * Muon's step on the card against the same step on the CPU: 1e-4
    absolute + 1e-4 relative on directions (the Newton–Schulz output
    above, scaled by sqrt(rows/cols) <= 2) and 1e-5 max(1, |x|) on the
    moments (elementwise).
  * the async flush of one-client qblock messages with staleness weights,
    on the card against the same flush on the CPU: the staleness
    histogram exact, every other output within 1e-5 max(1, |x|) — the
    flush differs only in dequant_accumulate's sum order, 4 B u
    sum|w s q| <= 4 * 5 * 2^-24 * 5 = 6e-6 for B = 5 inputs in [-1, 1],
    and the drift's plain reductions.
  * ``obs.profile_kernels``: a "ref" and a "kernel" row per triad, and
    each kernel output within its own bound above of the plain output.
  * householder_qr_group (one launch of its own kernel, in place): on
    inputs G/sqrt(k) + 3 I (singular values in about [2, 4], so every
    column of Q is well determined) Q within 1e-4 of torch.linalg.qr's and
    of the plain version's (LAPACK's conventions on both sides; f32
    Householder QR errs by O(k u) times the condition number), max |Q^T Q
    - I| <= 1e-5 and ||Q Q^T A - A|| / ||A|| <= 1e-5 (k u sqrt(k) for k <=
    4096); on a rank-deficient L and a zero input the same orthogonality
    (a zero input gives exactly I); two calls bitwise equal.
  * SOAP's refresh with the kernel against the same step with
    torch.linalg.qr, on full-rank SPD factors: each leaf's direction
    within 0.03 of the other's norm (the ViT cell's ``grad.r1`` limit).
"""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels.ns_ortho.kernel import (
    MAX_PROBLEMS, matmul_fused, matmul_fused_group, matmul_fused_group_plain,
    matmul_fused_plain,
)
from repro_torch.kernels.soap_rotate.kernel import (
    adam_moments, adam_moments_plain,
)
from repro_torch.kernels.householder_qr.kernel import (
    householder_qr_group, householder_qr_plain,
)
from repro_torch.kernels.fused_agg.kernel import (
    MAX_LEAVES as DA_MAX_LEAVES, dequant_accumulate,
    dequant_accumulate_group, dequant_accumulate_plain,
)
from repro_torch.kernels.qblock.kernel import (
    MAX_LEAVES as QB_MAX_LEAVES, quantize, quantize_group, quantize_plain,
)
from repro_torch.kernels.ns_ortho import ops as ns_ops
from repro_torch.kernels.soap_rotate.ops import soap_rotated_update
from repro_torch.kernels.sophia_update.kernel import (
    MAX_LEAVES as SU_MAX_LEAVES, sophia_update, sophia_update_group,
    sophia_update_plain,
)

U = 2.0 ** -24

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only there")
    # the bounds below are for f32 sums: keep the reference products out
    # of TF32 for this test only
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _randn(gen, *shape, dev):
    return torch.randn(shape, generator=gen).to(dev)


def _bound(lhs, rhs, aux, alpha, beta):
    mag = abs(alpha) * torch.matmul(lhs.abs().double(), rhs.abs().double())
    if aux is not None:
        mag = mag + abs(beta) * aux.abs().double()
    return 2 * (lhs.shape[-1] + 2) * U * mag + 1e-30


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _bits(x):
    """``x``'s bits as integers of its width (NaN compares by payload)."""
    return x.view({4: torch.int32, 2: torch.int16}[x.element_size()])


def _f32_casts(problem):
    """(lhs, rhs, aux, ...) with f32 copies of its operands."""
    lhs, rhs, aux, *rest = problem
    return (lhs.float(), rhs.float(), None if aux is None else aux.float(),
            *rest[:2])


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (130, 257, 50), (256, 64, 384),
                                   (192, 576, 192), (768, 192, 768),
                                   (27, 8, 27), (192, 5, 576)])
@pytest.mark.parametrize("layout", ["plain", "transposed"])
@pytest.mark.parametrize("dtypes", ["f32", "bf16,f32,bf16", "f32,bf16,f32",
                                    "f16", "f16,f32,bf16"])
def test_matmul_fused_kernel_matches_plain(cuda, m, k, n, layout, dtypes):
    """lhs, rhs, aux in ``dtypes`` (one for all, or one each): the output
    in lhs's dtype, bitwise the kernel on f32 casts rounded to it; the f32
    result within the bound of the plain version."""
    dl, dr, dx = (DTYPES[d] for d in (dtypes.split(",") * 3)[:3])
    gen = torch.Generator().manual_seed(m * 1000 + k + n)
    lhs = _randn(gen, 3, m, k, dev=cuda).to(dl)
    rhs = _randn(gen, 3, k, n, dev=cuda).to(dr)
    aux = _randn(gen, 3, m, n, dev=cuda).to(dx)
    if layout == "transposed":     # operands as transposed views
        lhs = lhs.transpose(1, 2).contiguous().transpose(1, 2)
        rhs = rhs.transpose(1, 2).contiguous().transpose(1, 2)
    before = matmul_fused.launches
    got = matmul_fused(lhs, rhs, aux, alpha=0.05, beta=0.95)
    wide, = matmul_fused_group([(lhs, rhs, aux, 0.05, 0.95, torch.float32)])
    on_casts = matmul_fused(*_f32_casts((lhs, rhs, aux)), alpha=0.05,
                            beta=0.95)
    torch.cuda.synchronize()
    assert matmul_fused.launches == before + 3
    assert got.dtype == dl and wide.dtype == torch.float32
    assert torch.equal(_bits(wide), _bits(on_casts))
    assert torch.equal(_bits(got), _bits(on_casts.to(dl)))
    casts = [t.cpu() for t in _f32_casts((lhs, rhs, aux))[:3]]
    want = matmul_fused_plain(*casts, alpha=0.05, beta=0.95)
    err = (wide.cpu().double() - want.double()).abs()
    assert bool((err <= _bound(*casts, 0.05, 0.95)).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8])
def test_matmul_fused_kernel_rejects_unsupported_dtypes(cuda, dtype):
    """f32, bf16 and f16 only, for every operand and the output: no
    silent cast."""
    x = torch.ones(4, 4, device=cuda)
    y = torch.ones(4, 4, device=cuda, dtype=dtype)
    before = matmul_fused.launches
    for problem in [(y, x, None, 1.0, 0.0), (x, y, None, 1.0, 0.0),
                    (x, x, y, 1.0, 1.0), (x, x, None, 1.0, 0.0, dtype)]:
        with pytest.raises(TypeError, match="float32, bfloat16 and float16"):
            matmul_fused_group([problem])
    assert matmul_fused.launches == before


def _mixed_group(gen, dev):
    """SOAP's six forms per leaf on ViT-like and the CNN's misaligned
    shapes (27 x 8: 108-byte rows), the identity Q as a batch-stride-0
    ``expand``, transposed views, with and without aux, varied alpha/beta,
    and an operand at a 4-byte storage offset."""
    problems = []
    for s, m, n in ((5, 192, 576), (5, 192, 192), (2, 768, 192),
                    (2, 27, 8), (2, 8, 16), (2, 16, 32)):
        g = _randn(gen, s, m, n, dev=dev)
        ql = _randn(gen, s, m, m, dev=dev)
        eye = torch.eye(n, device=dev).expand(s, n, n)
        gt = g.transpose(1, 2)
        problems += [
            (g, gt, _randn(gen, s, m, m, dev=dev), 0.05, 0.95),
            (gt, g, _randn(gen, s, n, n, dev=dev), 0.05, 0.95),
            (ql.transpose(1, 2), g, None, 1.0, 0.0),
            (g, eye, None, 1.0, 0.0),
            (ql, g, _randn(gen, s, m, n, dev=dev), -0.5, 2.0),
            (g, eye.transpose(1, 2), None, 0.7, 0.0),
        ]
    big = _randn(gen, 3, 41, 30, dev=dev)
    problems.append((big[:, 1:, 1:], _randn(gen, 3, 29, 13, dev=dev), None,
                     1.0, 0.0))
    return problems


def _assert_group_close(problems, got):
    want = matmul_fused_group_plain(
        [(a.cpu(), b.cpu(), None if x is None else x.cpu(), al, be)
         for a, b, x, al, be in problems])
    assert len(got) == len(want)
    for (a, b, x, al, be), gv, wv in zip(problems, got, want):
        assert gv.shape == wv.shape
        err = (gv.cpu().double() - wv.double()).abs()
        bound = _bound(a.cpu(), b.cpu(), None if x is None else x.cpu(), al,
                       be)
        assert bool((err <= bound).all()), (tuple(a.shape), tuple(b.shape))


def test_matmul_fused_group_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(13)
    problems = _mixed_group(gen, cuda)
    before = matmul_fused.launches
    got = matmul_fused_group(problems)
    torch.cuda.synchronize()
    assert matmul_fused.launches == before + 1
    _assert_group_close(problems, got)


def test_matmul_fused_group_of_mixed_dtypes(cuda):
    """The mixed group as SOAP at a bf16 or f16 state_dtype runs it —
    factors (aux, the Q's) in the 2-byte dtype, G and N in f32, the EMAs
    written in the factor's dtype and the rotations in f32 — in one
    launch: each output bitwise the same group on f32 casts (rounded to
    its dtype), within the bound of the plain version."""
    def to(x, half):      # the expanded identity keeps its batch stride 0
        return x[0].to(half).expand(x.shape) if x.stride(0) == 0 \
            else x.to(half)

    gen = torch.Generator().manual_seed(19)
    for half in (torch.bfloat16, torch.float16):
        problems = []
        for lhs, rhs, aux, alpha, beta in _mixed_group(gen, cuda):
            if aux is not None and alpha == 0.05:      # the EMA forms
                problems.append((lhs, rhs, to(aux, half), alpha, beta, half))
            elif lhs.shape[-1] == lhs.shape[-2]:       # Q @ N
                problems.append((to(lhs, half), rhs, aux, alpha, beta,
                                 torch.float32))
            else:                                      # G @ Q
                problems.append((lhs, to(rhs, half), aux, alpha, beta,
                                 torch.float32))
        # a 2-byte operand at a 2-byte storage offset, 41-element rows
        big = _randn(gen, 3, 41, 30, dev=cuda).to(half)
        problems.append((big[:, 1:, 1:], _randn(gen, 3, 29, 13, dev=cuda),
                         None, 1.0, 0.0, half))
        before = matmul_fused.launches
        got = matmul_fused_group(problems)
        on_casts = matmul_fused_group([_f32_casts(p) for p in problems])
        torch.cuda.synchronize()
        assert matmul_fused.launches == before + 2
        for p, g, w in zip(problems, got, on_casts):
            assert g.dtype == p[5]
            assert torch.equal(_bits(g), _bits(w.to(p[5])))
        _assert_group_close([_f32_casts(p) for p in problems], on_casts)


def test_matmul_fused_group_splits_at_the_table_limit(cuda):
    """A group above MAX_PROBLEMS takes one launch per MAX_PROBLEMS
    problems, and each launch is counted."""
    gen = torch.Generator().manual_seed(17)
    problems = []
    for i in range(MAX_PROBLEMS + 40):
        m, k, n = 5 + i % 7, 3 + i % 11, 4 + i % 5
        problems.append((_randn(gen, 2, m, k, dev=cuda),
                         _randn(gen, 2, k, n, dev=cuda),
                         _randn(gen, 2, m, n, dev=cuda) if i % 2 else None,
                         0.5 + i % 3, -1.0))
    before = matmul_fused.launches
    got = matmul_fused_group(problems)
    torch.cuda.synchronize()
    assert matmul_fused.launches == before + 2
    _assert_group_close(problems, got)


def test_matmul_fused_group_rejects_bad_problems(cuda):
    x = torch.ones(2, 4, 4, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        matmul_fused_group([(x, x, None, 1.0, 0.0),
                            (x, x.double(), None, 1.0, 0.0)])
    with pytest.raises(ValueError, match="shape mismatch"):
        matmul_fused_group([(x, x, None, 1.0, 0.0),
                            (x, torch.ones(2, 5, 4, device=cuda), None, 1.0,
                             0.0)])
    with pytest.raises(ValueError, match="several devices"):
        matmul_fused_group([(x, x, None, 1.0, 0.0),
                            (x.cpu(), x.cpu(), None, 1.0, 0.0)])


def _ns_inputs(gen, dev):
    """Wide, tall (read as its transpose), square, 3-D and cohort-stacked
    4-D inputs: one ViT-Tiny block's four matrix leaves at S=5 (w2 tall),
    a CNN stem's (27, 8) (rows of 108 bytes), an expert stack (2, 3, 10,
    24), a tall stack read through a non-mergeable view, and a bf16
    leaf."""
    mats = [_randn(gen, *shape, dev=dev) for shape in
            ((5, 192, 576), (5, 192, 192), (5, 192, 768), (5, 768, 192),
             (2, 27, 8), (2, 3, 10, 24), (130, 70))]
    mats[1][1] *= 100.0                  # a client 100x the others' norm
    mats.append(_randn(gen, 4, 3, 40, 24, dev=dev)[:, 1:])   # a strided view
    mats.append(_randn(gen, 2, 64, 96, dev=dev).to(torch.bfloat16))
    return mats


def test_newton_schulz_group_kernel_matches_plain(cuda):
    """One launch of the newton_schulz kernel and none of matmul_fused;
    the output within 1e-4 of the plain version (f32 against f64 of the
    same iteration differs by <= 8.4e-7 at ViT-Tiny shapes; entries are
    <= 0.3) and two calls bitwise equal."""
    gen = torch.Generator().manual_seed(23)
    mats = _ns_inputs(gen, cuda)
    before = (ns_ops.newton_schulz_group.launches, matmul_fused.launches)
    got = ns_ops.newton_schulz_group(mats)
    torch.cuda.synchronize()
    assert (ns_ops.newton_schulz_group.launches,
            matmul_fused.launches) == (before[0] + 1, before[1])
    again = ns_ops.newton_schulz_group(mats)
    want = ns_ops.newton_schulz_group_plain([m.cpu() for m in mats])
    for m, g, g2, w in zip(mats, got, again, want):
        assert g.shape == m.shape and g.is_cuda and g.dtype == torch.float32
        assert torch.equal(g, g2)
        assert float((g.cpu() - w).abs().max()) <= 1e-4, tuple(m.shape)


def test_newton_schulz_group_splits_at_the_table_limit(cuda):
    """A list above MAX_MATS takes one launch per MAX_MATS matrices, each
    counted, and agrees with the plain version; bad inputs raise."""
    gen = torch.Generator().manual_seed(19)
    mats = [_randn(gen, 2, 5 + i % 7, 9 + i % 5, dev=cuda)
            for i in range(ns_ops.MAX_MATS + 3)]
    before = ns_ops.newton_schulz_group.launches
    got = ns_ops.newton_schulz_group(mats, steps=3)
    torch.cuda.synchronize()
    assert ns_ops.newton_schulz_group.launches == before + 2
    want = ns_ops.newton_schulz_group_plain([m.cpu() for m in mats], steps=3)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4
    x = torch.ones(3, 4, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ns_ops.newton_schulz_group([x, x.double()])
    with pytest.raises(ValueError, match="several devices"):
        ns_ops.newton_schulz_group([x, x.cpu()])


def test_muon_step_on_the_card_matches_the_cpu_step(cuda):
    """Two local steps of Muon over a cohort-stacked ViT block (S=3) and
    an Adam-fallback leaf: the card's step (one newton_schulz launch a
    step, no matmul_fused) against the same step on the CPU."""
    from repro_torch.optim import muon

    gen = torch.Generator().manual_seed(29)
    shapes = {"blk": {"wqkv": (3, 48, 144), "wo": (3, 48, 48),
                      "w1": (3, 48, 192), "w2": (3, 192, 48)},
              "norm": {"scale": (3, 48)}}

    def draw():
        return {a: {b: torch.randn(sh, generator=gen)
                    for b, sh in v.items()} for a, v in shapes.items()}

    def to(tree, dev):
        return {a: {b: None if x is None else x.to(dev)
                    for b, x in v.items()} for a, v in tree.items()}

    params, grads = draw(), [draw(), draw()]
    opt = muon.make()
    sts = {d: opt.init(to(params, d), lead=1) for d in ("cpu", cuda)}
    for k, g in enumerate(grads):
        out = {}
        for d in ("cpu", cuda):
            before = (ns_ops.newton_schulz_group.launches,
                      matmul_fused.launches)
            out[d], sts[d] = opt.update(to(g, d), sts[d], to(params, d), k,
                                        lead=1)
            if d == cuda:
                torch.cuda.synchronize()
                assert (ns_ops.newton_schulz_group.launches,
                        matmul_fused.launches) == (before[0] + 1, before[1])
        got_dir = to(out[cuda], "cpu")
        for a, v in out["cpu"].items():
            for b, want in v.items():
                torch.testing.assert_close(got_dir[a][b], want, rtol=1e-4,
                                           atol=1e-4)
        for name in ("m", "am", "av"):
            got_st = to(sts[cuda][name], "cpu")
            for a, v in sts["cpu"][name].items():
                for b, want in v.items():
                    got = got_st[a][b]
                    assert (got is None) == (want is None)
                    if want is not None:
                        err = (got - want).abs()
                        assert bool((err <= 1e-5 * want.abs().clamp(
                            min=1.0)).all()), (name, a, b)


# ViT-Tiny's 96 refresh sides (12 blocks of wqkv, wo, w1, w2) at S=20
VIT_QR_SIDES = [192, 576, 192, 192, 192, 768, 768, 192] * 12


def _qr_inputs(gen, s, sides, dev):
    return [(_randn(gen, s, k, k, dev=dev) / k ** 0.5
             + 3 * torch.eye(k, device=dev)) for k in sides]


def _orth_gap(q):
    eye = torch.eye(q.shape[-1], device=q.device, dtype=q.dtype)
    return float((q.mT @ q - eye).abs().max())


def _assert_qr(xs, qs, plain=True):
    for x, q in zip(xs, qs):
        assert q.shape == x.shape and q.dtype == torch.float32
        eye = torch.eye(x.shape[-1], device=x.device)
        assert float((q.mT @ q - eye).abs().max()) <= 1e-5, tuple(x.shape)
        rec = torch.linalg.vector_norm(q @ (q.mT @ x) - x)
        assert float(rec / torch.linalg.vector_norm(x)) <= 1e-5
        assert float((q - torch.linalg.qr(x)[0]).abs().max()) <= 1e-4
        if plain:
            want = householder_qr_plain([x])[0]
            assert float((q - want).abs().max()) <= 1e-4, tuple(x.shape)


@pytest.mark.parametrize("case", ["vit", "lm", "4096"])
def test_householder_qr_group_matches_lapack_and_plain(cuda, case):
    """ViT-Tiny's refresh in one mixed group (one launch), LM SOAP's
    sides (2 x 960, 2 x 2560) and one 4096^2 matrix (its panels through
    device memory); two calls bitwise equal."""
    gen = torch.Generator().manual_seed(31)
    xs = {"vit": lambda: _qr_inputs(gen, 20, VIT_QR_SIDES, cuda),
          "lm": lambda: _qr_inputs(gen, 2, [960, 2560], cuda),
          "4096": lambda: _qr_inputs(gen, 1, [4096], cuda)}[case]()
    before = householder_qr_group.launches
    got = householder_qr_group([x.clone() for x in xs])
    torch.cuda.synchronize()
    assert householder_qr_group.launches == before + 1
    again = householder_qr_group([x.clone() for x in xs])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_qr(xs, got, plain=case != "4096")


def test_householder_qr_group_rank_deficient_zero_and_ragged(cuda):
    """L after one EMA step (rank 40 of 192), a zero input (Q = I), the
    identity, and ragged sizes (tall, n not a multiple of the panel or of
    4, one resident and one through device memory), each within the bounds
    above."""
    gen = torch.Generator().manual_seed(37)
    g = _randn(gen, 4, 192, 40, dev=cuda)
    low = 0.05 * g @ g.mT
    zero = torch.zeros(2, 576, 576, device=cuda)
    eye = torch.eye(200, device=cuda).expand(3, 200, 200).contiguous()
    ragged = [_randn(gen, 3, 70, 33, dev=cuda), _randn(gen, 2, 301, 257,
                                                       dev=cuda),
              _randn(gen, 1, 1, dev=cuda), _randn(gen, 5, 129, 97, dev=cuda)]
    got = householder_qr_group([x.clone() for x in
                                [low, zero, eye, *ragged]])
    q = got[0]
    assert float((q.mT @ q - torch.eye(192, device=cuda)).abs().max()) \
        <= 1e-5
    assert float(torch.linalg.vector_norm(q @ (q.mT @ low) - low)
                 / torch.linalg.vector_norm(low)) <= 1e-5
    assert torch.equal(got[1], torch.eye(576, device=cuda).expand(2, 576,
                                                                  576))
    assert torch.equal(got[2], eye)
    for x, q in zip(ragged, got[3:]):
        want = householder_qr_plain([x])[0]
        assert float((q - want).abs().max()) <= 1e-4, tuple(x.shape)
        assert float((q - torch.linalg.qr(x)[0]).abs().max()) <= 1e-4


@pytest.mark.parametrize("scale", [1e-30, 1e-40, 1e25])
def test_householder_qr_group_extreme_scales(cuda, scale):
    """Entries whose squares underflow (1e-30, subnormal 1e-40) or
    overflow (1e25), in shared memory and through device memory: the
    scaled norm and slarfg's rescaling keep Q orthogonal and its first
    column (one reflector of the input itself) the plain version's; at
    normal magnitudes all of Q.  Subnormal entries carry ~1e-5 of relative
    precision, and the blocked and unblocked updates round them
    differently, so there only Q Q^T A = A is held (in f64, to 1e-3)."""
    gen = torch.Generator().manual_seed(47)
    xs = [torch.randn(2, 40, 40, generator=gen) * scale,
          torch.randn(1, 300, 300, generator=gen) * scale]
    got = householder_qr_group([x.to(cuda) for x in xs])
    for x, q in zip(xs, got):
        q = q.cpu()
        want = householder_qr_plain([x])[0]
        assert bool(torch.isfinite(q).all())
        assert _orth_gap(q) <= 1e-5, tuple(x.shape)
        assert float((q[..., 0] - want[..., 0]).abs().max()) <= 1e-5
        if scale >= 1e-30:
            assert float((q - want).abs().max()) <= 1e-4, tuple(x.shape)
        a, qd = x.double(), q.double()
        rec = torch.linalg.vector_norm(qd @ (qd.mT @ a) - a)
        assert float(rec / torch.linalg.vector_norm(a)) <= 1e-3


def test_householder_qr_group_rejects_bad_inputs(cuda):
    x = torch.ones(3, 4, 4, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        householder_qr_group([x.double()])
    with pytest.raises(ValueError, match="contiguous"):
        householder_qr_group([torch.ones(3, 4, 8, device=cuda)[..., :4]])
    with pytest.raises(ValueError, match="m >= n"):
        householder_qr_group([torch.ones(3, 4, device=cuda)])
    with pytest.raises(ValueError, match="several devices"):
        householder_qr_group([x, x.cpu()])


def _soap_vit(gen, s, dev):
    """ViT-Tiny's 48 matrix leaves at S=s, SOAP state from a warm start:
    full-rank SPD L and R (G G^T / k + I), Q's from a previous refresh."""
    from repro_torch.optim import soap
    shapes = [(192, 576), (192, 192), (192, 768), (768, 192)] * 12
    params = {f"w{i}": _randn(gen, s, m, n, dev=dev)
              for i, (m, n) in enumerate(shapes)}
    grads = {k: _randn(gen, *v.shape, dev=dev) for k, v in params.items()}
    opt = soap.make()
    st = opt.init(params, lead=1)
    for k, leaf in st["mat"].items():
        for f in ("L", "R"):
            a = _randn(gen, *leaf[f].shape, dev=dev)
            leaf[f] = a @ a.mT / a.shape[-1] + torch.eye(a.shape[-1],
                                                         device=dev)
    return opt, params, grads, st


def test_soap_refresh_launches_the_kernel_not_cusolver(cuda):
    """A SOAP step at its refresh on ViT-Tiny (S=20): one householder_qr
    launch, and no cuSOLVER QR kernel (geqr, orgqr, larf) in its trace."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(41)
    opt, params, grads, st = _soap_vit(gen, 20, cuda)
    before = householder_qr_group.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opt.update(grads, st, params, 0, lead=1)
        torch.cuda.synchronize()
    assert householder_qr_group.launches == before + 1
    names = [e.key.lower() for e in prof.key_averages()]
    assert any("householder" in k for k in names)
    assert not [k for k in names if any(p in k for p in
                                        ("geqr", "orgqr", "larf"))]


def test_soap_step_with_the_kernel_matches_torch_linalg_qr(cuda,
                                                          monkeypatch):
    """One ViT-Tiny S=20 SOAP step at its refresh: the kernel against the
    same step with torch.linalg.qr in its place, each leaf's direction
    within 0.03 of the other's norm."""
    from repro_torch.optim import soap
    gen = torch.Generator().manual_seed(43)
    opt, params, grads, st = _soap_vit(gen, 20, cuda)
    got, _ = opt.update(grads, st, params, 0, lead=1)
    monkeypatch.setattr(soap, "_on_kernel", lambda qs: False)
    want, _ = opt.update(grads, st, params, 0, lead=1)
    for k, w in want.items():
        gap = torch.linalg.vector_norm(got[k] - w)
        assert float(gap / torch.linalg.vector_norm(w)) <= 0.03, k


def test_takes_group_counts_the_cards_resident_ctas(cuda):
    """A group of matrices too large for shared memory goes to the kernel
    from as many as the card holds CTAs at once."""
    from repro_torch.kernels.householder_qr import kernel as hqr
    r = hqr.kernel_library().resident_blocks()
    assert r >= 1
    assert hqr.takes_group([torch.empty(r, 300, 300, device=cuda)])
    assert not hqr.takes_group([torch.empty(r - 1, 300, 300, device=cuda)])
    assert hqr.takes_group([torch.empty(1, 192, 192, device=cuda)])


def test_soap_refresh_sends_few_large_sides_to_torch_linalg_qr(cuda):
    """A SOAP refresh of four matrices of 600 and 300 (fewer than the
    card's CTAs, none in shared memory) launches no kernel; its Q's are
    orthogonal."""
    from repro_torch.optim import soap
    gen = torch.Generator().manual_seed(53)
    params = {"w": _randn(gen, 2, 600, 300, dev=cuda)}
    grads = {"w": _randn(gen, 2, 600, 300, dev=cuda)}
    opt = soap.make()
    st = opt.init(params, lead=1)
    st["mat"]["w"]["L"] = grads["w"] @ grads["w"].mT
    st["mat"]["w"]["R"] = grads["w"].mT @ grads["w"]
    before = householder_qr_group.launches
    _, new = opt.update(grads, st, params, 0, lead=1)
    torch.cuda.synchronize()
    assert householder_qr_group.launches == before
    for q in ("QL", "QR"):
        assert _orth_gap(new["mat"]["w"][q]) <= 1e-5


@pytest.mark.parametrize("shape", [(5, 192, 576), (7,), (3, 40, 50)])
@pytest.mark.parametrize("step", [None, 3])
def test_adam_moments_kernel_matches_plain(cuda, shape, step):
    gen = torch.Generator().manual_seed(len(shape) + (step or 0))
    g, m = _randn(gen, *shape, dev=cuda), _randn(gen, *shape, dev=cuda)
    v = torch.rand(shape, generator=gen).to(cuda)
    before = adam_moments.launches
    got = adam_moments(g, m, v, step=step)
    torch.cuda.synchronize()
    assert adam_moments.launches == before + 1
    want = adam_moments_plain(g.cpu(), m.cpu(), v.cpu(), step=step)
    for name, gv, wv, rel in zip("nmv", got, want, (1e-5, 1e-6, 1e-6)):
        err = (gv.cpu() - wv).abs()
        assert bool((err <= rel * wv.abs().clamp(min=1.0)).all()), name


@pytest.mark.parametrize("sides", ["both", "left", "right"])
def test_soap_rotated_update_kernels_match_plain(cuda, sides):
    gen = torch.Generator().manual_seed(11)
    s, m, n = 5, 192, 768
    g = _randn(gen, s, m, n, dev=cuda)
    ql = torch.linalg.qr(_randn(gen, s, m, m, dev=cuda))[0]
    qr = torch.linalg.qr(_randn(gen, s, n, n, dev=cuda))[0]
    mm = _randn(gen, s, m, n, dev=cuda)
    vv = torch.rand((s, m, n), generator=gen).to(cuda)
    ql = None if sides == "right" else ql
    qr = None if sides == "left" else qr
    got = soap_rotated_update(g, ql, qr, mm, vv, step=2)
    want = soap_rotated_update(
        *(x.cpu() if x is not None else None for x in (g, ql, qr, mm, vv)),
        step=2)
    for gv, wv in zip(got, want):
        err = (gv.cpu() - wv).abs()
        assert bool((err <= 1e-4 * wv.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("shape", [(5, 192, 576), (7,), (5, 65, 192)])
def test_sophia_update_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(len(shape))
    g, m = _randn(gen, *shape, dev=cuda), _randn(gen, *shape, dev=cuda)
    h = torch.rand(shape, generator=gen).to(cuda) * 50
    h.view(-1)[::3] = 0.0                  # the clip saturates
    before = sophia_update.launches
    got = sophia_update(g, m, h, b1=0.9, rho=0.05, eps=1e-12)
    torch.cuda.synchronize()
    assert sophia_update.launches == before + 1
    want = sophia_update_plain(g.cpu(), m.cpu(), h.cpu(), b1=0.9, rho=0.05,
                               eps=1e-12)
    for gv, wv in zip(got, want):
        err = (gv.cpu() - wv).abs()
        assert bool((err <= 1e-6 * wv.abs().clamp(min=1.0)).all())


def _sophia_group(gen, dev):
    """(g, m, h) leaves as Sophia's step sees them — ViT- and CNN-shaped
    stacks — plus NaN and +-inf in h and g, saturating clips (h = 0),
    ragged sizes, and views at a 4-byte offset (scalar accesses)."""
    leaves = []
    for shape in ((5, 192, 576), (5, 192), (5, 768, 192), (2, 3, 3, 3, 8),
                  (2, 8), (2, 1, 1, 8, 16), (1001,), (3, 7, 9)):
        g, m = _randn(gen, *shape, dev=dev), _randn(gen, *shape, dev=dev)
        h = torch.rand(shape, generator=gen).to(dev) * 50
        h.view(-1)[::3] = 0.0
        leaves.append((g, m, h))
    g, m, h = leaves[4]
    h.view(-1)[:4] = torch.tensor([float("nan"), float("inf"),
                                   -float("inf"), 1e-30])
    g.view(-1)[4:8] = torch.tensor([float("nan"), float("inf"),
                                    -float("inf"), 0.0])
    big = [_randn(gen, 4097, dev=dev) for _ in range(3)]
    leaves.append(tuple(x[1:] for x in big))        # 4-byte offset, ragged
    return leaves


def _assert_bitwise(got, want, what):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32)), what


def test_sophia_update_group_bitwise_matches_plain(cuda):
    gen = torch.Generator().manual_seed(23)
    leaves = _sophia_group(gen, cuda)
    gs, ms, hs = (list(x) for x in zip(*leaves))
    before = sophia_update.launches
    ds, mos = sophia_update_group(gs, ms, hs, b1=0.9, rho=0.05, eps=1e-12)
    torch.cuda.synchronize()
    assert sophia_update.launches == before + 1
    for (g, m, h), d, mo in zip(leaves, ds, mos):
        want_d, want_m = sophia_update_plain(g, m, h, b1=0.9, rho=0.05,
                                             eps=1e-12)
        _assert_bitwise(d, want_d, ("d", tuple(g.shape)))
        _assert_bitwise(mo, want_m, ("m", tuple(g.shape)))
    d = ds[4].view(-1).cpu()
    assert torch.isnan(d[[0, 4]]).all()         # NaN h, NaN g stay NaN


def test_sophia_update_group_splits_at_the_table_limit(cuda):
    gen = torch.Generator().manual_seed(29)
    leaves = [tuple(_randn(gen, 2, 3 + i % 9, dev=cuda) for _ in range(3))
              for i in range(SU_MAX_LEAVES + 5)]
    gs, ms, hs = (list(x) for x in zip(*leaves))
    before = sophia_update.launches
    ds, mos = sophia_update_group(gs, ms, [h.abs() for h in hs])
    torch.cuda.synchronize()
    assert sophia_update.launches == before + 2
    for (g, m, h), d, mo in zip(leaves, ds, mos):
        want_d, want_m = sophia_update_plain(g, m, h.abs())
        _assert_bitwise(d, want_d, g.shape)
        _assert_bitwise(mo, want_m, g.shape)


def _tied(gen, rows, n, block, dev):
    x = torch.randn((rows, n), generator=gen) * 3
    k = torch.randint(-126, 126, (rows, min(block, n)), generator=gen)
    x[:, :min(block, n)] = (k + 0.5) * 0.125       # exact ties at scale 1/8
    x[:, 0] = 127 * 0.125
    if n > 2 * block:
        x[:, block:2 * block] = 0.0                # an all-zero block
    return x.to(dev)


@pytest.mark.parametrize("rows,n", [(5, 110592), (5, 192), (2, 10),
                                    (3, 1000), (1, 128)])
@pytest.mark.parametrize("block", [128, 256])
def test_quantize_kernel_bitwise_matches_plain(cuda, rows, n, block):
    gen = torch.Generator().manual_seed(rows * n + block)
    x = _tied(gen, rows, n, block, cuda)
    before = quantize.launches
    q, s = quantize(x, block=block)
    torch.cuda.synchronize()
    assert quantize.launches == before + 1
    wq, ws = quantize_plain(x.cpu(), block=block)
    assert torch.equal(q.cpu(), wq) and torch.equal(s.cpu(), ws)


def test_quantize_kernel_rejects_unaligned_block(cuda):
    with pytest.raises(ValueError, match="multiples of 128"):
        quantize(torch.ones(2, 10, device=cuda), block=64)


def _model_rows():
    """(rows, n) of every ViT-Tiny leaf at S=5 and every CNN leaf at S=2,
    as the qblock codec hands them to ``quantize_group``."""
    from repro_torch.models.vision import init_cnn, init_vit
    from repro_torch.utils.tree import tree_leaves
    gen = torch.Generator().manual_seed(0)
    vit, _ = init_vit(gen, image_size=32, n_classes=100, device="cpu",
                      patch=4, d_model=192, layers=12, heads=3)
    cnn = init_cnn(gen, n_classes=8, width=8, blocks=2, device="cpu")
    return ([(5, p.numel()) for p in tree_leaves(vit)]
            + [(2, p.numel()) for p in tree_leaves(cnn)])


def _assert_codes_match(x, q, s, block):
    """q and scale bitwise the plain version's; NaN scales where it has
    NaN, and codes compared only in blocks with a finite scale."""
    wq, ws = quantize_plain(x.cpu(), block=block)
    q, s = q.cpu(), s.cpu()
    assert q.shape == wq.shape and s.shape == ws.shape
    assert q.is_contiguous() and s.is_contiguous()
    nan = torch.isnan(ws)
    assert torch.equal(torch.isnan(s), nan)
    assert torch.equal(s[~nan], ws[~nan])
    ok = torch.isfinite(ws).repeat_interleave(block, dim=1)[:, :q.shape[1]]
    assert torch.equal(q[ok], wq[ok])


@pytest.mark.parametrize("block", [128, 256])
def test_quantize_group_bitwise_matches_plain(cuda, block):
    """Every ViT-Tiny and CNN leaf in one launch, plus ragged sizes, a
    leaf at a 4-byte offset (scalar accesses), and NaN and +-inf blocks."""
    gen = torch.Generator().manual_seed(41 + block)
    xs = [_tied(gen, r, n, block, cuda)
          for r, n in _model_rows() + [(3, 1001), (2, 10), (4, 777)]]
    big = _tied(gen, 3, 4097, block, cuda).view(-1)
    xs.append(big[1:3 * 4096 + 1].view(3, 4096))   # 4-byte offset
    xs[6].view(-1)[[3, 200]] = float("nan")         # (5, 147456)
    xs[6].view(-1)[[500, 900]] = torch.tensor([float("inf"),
                                               -float("inf")], device=cuda)
    xs[-2].view(-1)[5] = float("nan")               # a ragged leaf
    before = quantize.launches
    got = quantize_group(xs, block=block)
    torch.cuda.synchronize()
    assert quantize.launches == before + 1
    assert xs[-1].data_ptr() % 16 == 4
    for x, (q, s) in zip(xs, got):
        _assert_codes_match(x, q, s, block)
    s6 = got[6][1].cpu().view(-1)
    assert torch.isnan(s6[[0, 200 // block]]).all()
    assert torch.isinf(s6[[500 // block, 900 // block]]).all()


def test_quantize_group_splits_at_the_table_limit(cuda):
    gen = torch.Generator().manual_seed(43)
    xs = [_randn(gen, 2, 3 + i % 300, dev=cuda)
          for i in range(QB_MAX_LEAVES + 5)]
    before = quantize.launches
    got = quantize_group(xs)
    torch.cuda.synchronize()
    assert quantize.launches == before + 2
    for x, (q, s) in zip(xs, got):
        _assert_codes_match(x, q, s, 128)


def test_quantize_group_rejects_bad_leaves(cuda):
    x = torch.ones(2, 10, device=cuda)
    with pytest.raises(ValueError, match="multiples of 128"):
        quantize_group([x, x], block=192)
    with pytest.raises(TypeError, match="float32"):
        quantize_group([x, x.double()])
    with pytest.raises(ValueError, match="several devices"):
        quantize_group([x, x.cpu()])


@pytest.mark.parametrize("b,n", [(5, 110592), (5, 192), (2, 10), (3, 1001),
                                 (10, 4096)])
def test_dequant_accumulate_kernel_matches_plain(cuda, b, n):
    gen = torch.Generator().manual_seed(b * n)
    q, s = quantize_plain(torch.randn((b, n), generator=gen), block=128)
    w = torch.rand(b, generator=gen) + 0.2
    before = dequant_accumulate.launches
    got = dequant_accumulate(q.to(cuda), s.to(cuda), w.to(cuda), block=128)
    torch.cuda.synchronize()
    assert dequant_accumulate.launches == before + 1
    want = dequant_accumulate_plain(q, s, w, block=128)
    mag = ((w[:, None] * s).repeat_interleave(128, dim=1)[:, :n].abs()
           * q.float().abs()).sum(0)
    err = (got.cpu() - want).abs()
    assert tuple(got.shape) == (n,)
    assert bool((err <= 4 * b * U * mag + 1e-30).all())


def _da_bound(q, s, w, n):
    mag = ((w[:, None] * s).repeat_interleave(128, dim=1)[:, :n].abs()
           * q.float().abs()).sum(0)
    return 4 * q.shape[0] * U * mag + 1e-30


def test_dequant_accumulate_group_matches_plain(cuda):
    """A mixed list: ViT- and CNN-sized leaves, ragged n, and a q at a
    1-byte offset (byte loads)."""
    gen = torch.Generator().manual_seed(31)
    b = 5
    coded = [quantize_plain(torch.randn((b, n), generator=gen))
             for n in (110592, 192, 36864, 216, 8, 1001, 10, 4096)]
    coded.append(quantize_plain(torch.randn((b, 777), generator=gen)))
    w = torch.rand(b, generator=gen) + 0.2
    qs = [q.to(cuda) for q, _ in coded]
    buf = torch.empty(b * 777 + 1, dtype=torch.int8, device=cuda)
    buf[1:] = qs[-1].reshape(-1)
    qs[-1] = buf[1:].view(b, 777)
    before = dequant_accumulate.launches
    got = dequant_accumulate_group(qs, [s.to(cuda) for _, s in coded],
                                   w.to(cuda), block=128)
    torch.cuda.synchronize()
    assert dequant_accumulate.launches == before + 1
    assert qs[-1].data_ptr() % 4 == 1
    for (q, s), out in zip(coded, got):
        n = q.shape[1]
        assert tuple(out.shape) == (n,)
        err = (out.cpu() - dequant_accumulate_plain(q, s, w)).abs()
        assert bool((err <= _da_bound(q, s, w, n)).all()), n


def test_dequant_accumulate_group_splits_at_the_table_limit(cuda):
    gen = torch.Generator().manual_seed(37)
    coded = [quantize_plain(torch.randn((3, 5 + i % 300), generator=gen))
             for i in range(DA_MAX_LEAVES + 3)]
    w = torch.rand(3, generator=gen) + 0.2
    before = dequant_accumulate.launches
    got = dequant_accumulate_group([q.to(cuda) for q, _ in coded],
                                   [s.to(cuda) for _, s in coded],
                                   w.to(cuda))
    torch.cuda.synchronize()
    assert dequant_accumulate.launches == before + 2
    for (q, s), out in zip(coded, got):
        err = (out.cpu() - dequant_accumulate_plain(q, s, w)).abs()
        assert bool((err <= _da_bound(q, s, w, q.shape[1])).all())


def _carry_case(gen, b, ns):
    coded = [quantize_plain(torch.randn((b, n), generator=gen)) for n in ns]
    w = torch.rand(b, generator=gen) * 0.8 + 0.1       # w < 1
    carry = [torch.randn(n, generator=gen) for n in ns]
    return coded, w, carry


def test_dequant_accumulate_carry_bitwise_against_plain(cuda):
    """Vectorized leaves (n % 4 == 0, aligned) and ragged ones, a carry at
    a 4-byte offset (scalar loads), NaN in one carry: one launch, every
    output bitwise equal to the plain ``carry + sum``."""
    gen = torch.Generator().manual_seed(41)
    ns = (110592, 192, 36864, 216, 8, 1001, 10, 4096)
    coded, w, carry = _carry_case(gen, 4, ns)
    carry[5][7] = float("nan")
    dev_carry = [c.to(cuda) for c in carry]
    buf = torch.empty(4096 + 1, device=cuda)
    buf[1:] = carry[-1].to(cuda)
    dev_carry[-1] = buf[1:]
    assert dev_carry[-1].data_ptr() % 16 == 4
    before = dequant_accumulate.launches
    got = dequant_accumulate_group([q.to(cuda) for q, _ in coded],
                                   [s.to(cuda) for _, s in coded],
                                   w.to(cuda), carry=dev_carry)
    torch.cuda.synchronize()
    assert dequant_accumulate.launches == before + 1
    for (q, s), c, out in zip(coded, carry, got):
        want = dequant_accumulate_plain(q, s, w, carry=c)
        assert torch.equal(torch.isnan(out.cpu()), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(out.cpu()),
                           torch.nan_to_num(want))
    assert bool(torch.isnan(got[5][7]))


def test_dequant_accumulate_none_carry_unchanged_and_bitwise(cuda):
    gen = torch.Generator().manual_seed(43)
    coded, w, carry = _carry_case(gen, 4, (4096, 1001, 192))
    qs = [q.to(cuda) for q, _ in coded]
    ss = [s.to(cuda) for _, s in coded]
    plain = dequant_accumulate_group(qs, ss, w.to(cuda))
    again = dequant_accumulate_group(qs, ss, w.to(cuda), carry=None)
    folded = dequant_accumulate_group(qs, ss, w.to(cuda),
                                      carry=[c.to(cuda) for c in carry])
    for (q, s), c, a, b, f in zip(coded, carry, plain, again, folded):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), dequant_accumulate_plain(q, s, w))
        assert torch.equal(f.cpu(), c + a.cpu())
    one = dequant_accumulate(qs[0], ss[0], w.to(cuda),
                             carry=carry[0].to(cuda))
    assert torch.equal(one, folded[0])


def test_dequant_accumulate_kernel_rejects_unaligned_block(cuda):
    q, s = quantize_plain(torch.ones(2, 100), block=64)
    with pytest.raises(ValueError, match="multiples of 128"):
        dequant_accumulate(q.to(cuda), s.to(cuda), torch.ones(2, device=cuda),
                           block=64)


def test_port_imports_no_jax(cuda):
    """Every port module imports on the GPU host without JAX or the JAX
    package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    port = root / "src" / "repro_torch"
    mods = []
    for path in sorted(port.rglob("*.py")):
        rel = path.relative_to(port.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr


def test_async_flush_with_staleness_weights_matches_plain(cuda):
    """FedBuff's flush of five one-client qblock messages joined along the
    client axis, poly staleness weights w < 1 into ``dequant_accumulate``,
    against the same flush of the same messages on the CPU."""
    from repro_torch.core import transport as T
    from repro_torch.core.engine import make_controller
    from repro_torch.fed.async_runtime import (
        make_async_aggregate_fn, make_staleness_weight,
    )
    from repro_torch.utils.tree import tree_leaves, tree_map
    gen = torch.Generator().manual_seed(7)
    shapes = [(192, 576), (192,), (3, 3, 3, 8), (1001,)]

    def tree(lead):
        return {str(i): torch.rand((*lead, *s), generator=gen) * 2 - 1
                for i, s in enumerate(shapes)}

    params, theta, g = tree(()), tree_map(torch.abs, tree(())), tree(())
    deltas, thetas = tree((5,)), tree_map(torch.abs, tree((5,)))
    stale = [0, 1, 2, 3, 1]
    weight = make_staleness_weight("poly", alpha=0.5)
    w = torch.tensor([weight(s) for s in stale])
    tr = T.Transport(delta=T.QBlock(), theta=T.QBlock())

    def run(dev):
        def msgs(codec, x):
            return T.concat_clients([codec.encode(tree_map(
                lambda t: t[i:i + 1].to(dev), x)) for i in range(5)])

        flush = make_async_aggregate_fn(lr=0.02, local_steps=10,
                                        transport=tr, telemetry=True)
        before = dequant_accumulate.launches
        out = flush(*[tree_map(lambda t: t.to(dev), x)
                      for x in (params, theta, g)],
                    make_controller("auto", device=dev),
                    msgs(tr.delta, deltas), msgs(tr.theta, thetas),
                    w.to(dev), torch.tensor(stale, device=dev))
        return out, dequant_accumulate.launches - before

    (gp, gt, gg, gc, gm), launches = run(cuda)
    (wp, wt, wg, wc, wm), _ = run(torch.device("cpu"))
    assert launches == 3        # the delta, Theta's mean and its drift
    got = tree_leaves((gp, gt, gg)) + [gc.beta, gc.drift_ema, gm["drift"],
                                       gm["norm_drift"], gm["freshness"]]
    want = tree_leaves((wp, wt, wg)) + [wc.beta, wc.drift_ema, wm["drift"],
                                        wm["norm_drift"], wm["freshness"]]
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        err = (a.cpu() - b).abs()
        assert bool((err <= 1e-5 * b.abs().clamp(min=1.0)).all())
    ta, tb = gm["telemetry"], wm["telemetry"]
    assert ta.staleness_hist.tolist() == tb.staleness_hist.tolist() == [
        1, 2, 1, 1, 0, 0, 0, 0]
    for f in ("freshness", "update_corr_cos", "client_geom_dist"):
        a, b = getattr(ta, f).cpu(), getattr(tb, f)
        assert bool(((a - b).abs() <= 1e-5 * b.abs().clamp(min=1.0)).all())


def test_profile_kernels_on_the_card(cuda):
    """Both rows of every triad, timed on the card; each kernel output
    within its bound of the plain output on the same inputs."""
    from repro_torch.obs import profile_kernels
    from repro_torch.obs.profiling import KERNELS, kernel_cases
    shape = (256, 256)
    recs = profile_kernels(shapes=(shape,), iters=2)
    assert [(r["kernel"], r["impl"]) for r in recs] == [
        (k, i) for k in KERNELS for i in ("ref", "kernel")]
    assert all(r["backend"] == "cuda" and r["us_per_call"] > 0
               for r in recs)
    for name, fns, args, _, _ in kernel_cases(shape, device=cuda):
        ref, ker = fns["ref"](*args), fns["kernel"](*args)
        if name == "soap_rotate":
            for k, r in zip(ker, ref):
                assert bool(((k - r).abs() <= 1e-4 * r.abs().clamp(
                    min=1.0)).all())
        elif name in ("qblock", "sophia_update"):
            for k, r in zip(ker, ref):
                assert torch.equal(k, r)
        elif name == "ns_ortho":
            assert float((ker - ref).abs().max()) <= 1e-4
        else:
            q, scale, w = args
            mag = ((w[:, None] * scale).repeat_interleave(128, dim=1).abs()
                   * q.float().abs()).sum(0)
            assert bool(((ker - ref).abs()
                         <= 4 * q.shape[0] * U * mag).all())
