"""The port's hand-written Hopper kernels against their plain PyTorch
versions, on the card.  Every test here is marked ``cuda`` and skips on a
host without a CUDA device; this file imports no JAX, so it runs on a GPU
host that has none:

    python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances:
  * matmul_fused: the classical dot-product bound |err| <= 2 (k+2) u
    sum_k |a||b| (u = 2^-24) elementwise — two f32 sums in different
    orders.
  * adam_moments: 1e-6 max(1, |x|) on m', v' (the same expression, FMA
    contraction aside) and 1e-5 max(1, |n|) on n (a division and a square
    root, each rounded or approximated differently).
  * soap_rotated_update: 1e-4 max(1, |x|), the composition of the above.
"""
import pytest
import torch

from repro_torch.kernels.ns_ortho.kernel import (
    matmul_fused, matmul_fused_plain,
)
from repro_torch.kernels.soap_rotate.kernel import (
    adam_moments, adam_moments_plain,
)
from repro_torch.kernels.soap_rotate.ops import soap_rotated_update

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


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (130, 257, 50), (256, 64, 384),
                                   (192, 576, 192), (768, 192, 768),
                                   (27, 8, 27), (192, 5, 576)])
@pytest.mark.parametrize("layout", ["plain", "transposed"])
def test_matmul_fused_kernel_matches_plain(cuda, m, k, n, layout):
    gen = torch.Generator().manual_seed(m * 1000 + k + n)
    lhs = _randn(gen, 3, m, k, dev=cuda)
    rhs = _randn(gen, 3, k, n, dev=cuda)
    aux = _randn(gen, 3, m, n, dev=cuda)
    if layout == "transposed":     # operands as transposed views
        lhs = lhs.transpose(1, 2).contiguous().transpose(1, 2)
        rhs = rhs.transpose(1, 2).contiguous().transpose(1, 2)
    before = matmul_fused.launches
    got = matmul_fused(lhs, rhs, aux, alpha=0.05, beta=0.95)
    torch.cuda.synchronize()
    assert matmul_fused.launches == before + 1
    want = matmul_fused_plain(lhs.cpu(), rhs.cpu(), aux.cpu(), alpha=0.05,
                              beta=0.95)
    err = (got.cpu().double() - want.double()).abs()
    assert bool((err <= _bound(lhs.cpu(), rhs.cpu(), aux.cpu(), 0.05,
                               0.95)).all())


def test_matmul_fused_kernel_rejects_non_f32(cuda):
    x = torch.ones(4, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        matmul_fused(x, x)


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
