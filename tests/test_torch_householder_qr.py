"""The Householder QR kernel's CPU side: ``householder_qr_plain`` against
LAPACK (``torch.linalg.qr``, ``np.linalg.qr``), the wrapper's contract,
its host tables, which groups it takes, ``sharding.ops.qr_q`` and SOAP's
grouping and routing of its refresh.  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).

Tolerances: f32 Householder QR errs by O(n u) times the condition number
(u = 2^-24); on Gaussian inputs of n <= 96, 1e-5 on Q's entries against
LAPACK's (the same conventions: beta = -sign(alpha) ||(alpha, x)||), and
1e-5 on Q^T Q - I.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.householder_qr import kernel as hqr
from repro_torch.obs import counters
from repro_torch.optim import soap
from repro_torch.sharding import ops


def _orth_gap(q):
    n = q.shape[-1]
    return float((q.mT @ q - torch.eye(n, dtype=q.dtype)).abs().max())


@pytest.mark.parametrize("shape", [(1, 1), (5, 5), (48, 48), (96, 32),
                                   (2, 3, 10, 7)])
def test_plain_matches_lapack(shape):
    a = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    q = hqr.householder_qr_plain([a])[0]
    assert q.shape == a.shape and q.dtype == torch.float32
    torch.testing.assert_close(q, torch.linalg.qr(a)[0], rtol=0, atol=1e-5)
    want = np.linalg.qr(a.double().numpy())[0]
    assert float(np.abs(q.double().numpy() - want).max()) <= 1e-5
    assert _orth_gap(q) <= 1e-5


@pytest.mark.parametrize("make", [torch.zeros, torch.eye])
def test_zero_and_identity_give_identity(make):
    q = hqr.householder_qr_plain([make(6, 6)])[0]
    assert torch.equal(q, torch.eye(6))


def test_rank_deficient_input():
    """Rank 3 of 24: the range's columns are LAPACK's, the rest an
    orthonormal completion of its own."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(24, 3, generator=gen) @ torch.randn(3, 24, generator=gen)
    q = hqr.householder_qr_plain([a])[0]
    torch.testing.assert_close(q[:, :3], torch.linalg.qr(a)[0][:, :3],
                               rtol=0, atol=1e-5)
    assert _orth_gap(q) <= 1e-5


@pytest.mark.parametrize("scale", [1e-30, 1e-40, 1e25])
def test_norms_that_would_under_or_overflow(scale):
    """Entries whose squares underflow (1e-30, subnormal 1e-40) or
    overflow (1e25): the scaled norm and slarfg's rescaling keep Q
    LAPACK's."""
    a = torch.randn(6, 6, generator=torch.Generator().manual_seed(7))
    a = a * scale
    q = hqr.householder_qr_plain([a])[0]
    assert bool(torch.isfinite(q).all())
    torch.testing.assert_close(q, torch.linalg.qr(a)[0], rtol=0, atol=1e-5)


def test_wrapper_overwrites_cpu_inputs_in_place():
    a = torch.randn(2, 9, 5, generator=torch.Generator().manual_seed(9))
    want = hqr.householder_qr_plain([a])[0]
    x = a.clone()
    out = hqr.householder_qr_group([x])
    assert out[0] is x and torch.equal(x, want)
    assert hqr.householder_qr_group([]) == []


@pytest.mark.parametrize("bad,err,match", [
    (torch.ones(4, 4, dtype=torch.bfloat16), TypeError, "float32"),
    (torch.ones(4, 4, dtype=torch.float16), TypeError, "float32"),
    (torch.ones(4, 4, dtype=torch.float64), TypeError, "float32"),
    (torch.ones(3, 4), ValueError, "m >= n"),
    (torch.ones(5, 4).mT.mT[:, :3], ValueError, "contiguous"),
    (torch.ones(4), ValueError, "m >= n"),
])
def test_wrapper_contract(bad, err, match):
    with pytest.raises(err, match=match):
        hqr.householder_qr_group([bad])


def test_launch_plan_orders_largest_first_and_cuts_at_max_recs():
    dims = [(20, 192, 192), (20, 768, 768), (0, 8, 8), (20, 576, 576),
            (3, 300, 10)]
    (idx, count), = hqr.launch_plan(dims)
    assert list(idx) == [1, 3, 0, 4] and count == 63
    plans = hqr.launch_plan([(1, 4, 4)] * 5, max_recs=2)
    assert [list(i) for i, _ in plans] == [[0, 1], [2, 3], [4]]
    assert [c for _, c in plans] == [2, 2, 1]
    assert hqr.launch_plan([]) == []


# ViT-Tiny's refresh sides (12 blocks of wqkv, wo, w1, w2) and
# SmolLM-360M's (32 layers of q, k, v, o, gate, up, down; the embedding
# one-sided), as (sides, batch) for takes' (batch, m, n)
VIT_SIDES = [192, 576, 192, 192, 192, 768, 768, 192] * 12
SMOL_SIDES = [960, 960, 960, 320, 960, 320, 960, 960, 960, 2560, 960,
              2560, 2560, 960]
BIG = 41248            # the source's BIG_FLOATS: square matrices to 203


@pytest.mark.parametrize("dims,want", [
    ([(20, k, k) for k in VIT_SIDES], True),      # the ViT cell: 1,920
    ([(1, k, k) for k in VIT_SIDES], False),      # one client: 96
    ([(64, k, k) for k in SMOL_SIDES], True),     # SmolLM-360M S=2: 896
    ([(32, 2560, 2560), (32, 2560, 2560)], False),  # SmolLM bf16: 64
    ([(1, 8192, 8192)], False),                   # max_precond_dim
    ([(132, 2560, 2560)], True),                  # fills the card
    ([(1, 192, 192), (1, 203, 203)], True),       # fit shared memory
    ([(1, 204, 204)], False),
    ([(1, 300, 10), (0, 5000, 5000)], True),      # no work: not counted
])
def test_takes_groups_that_fit_shared_memory_or_fill_the_card(dims, want):
    assert hqr.takes(dims, resident=132, big_floats=BIG) is want


def test_launch_table_matches_the_kernel_layout():
    assert (hqr.HEAD.itemsize, hqr.REC.itemsize) == (16, 32)
    assert hqr.MAX_RECS == 1023 and hqr.TABLE_BYTES <= 32764
    rows = np.zeros(3, hqr.REC)
    rows["batch"], rows["m"], rows["n"] = (4, 2, 7), (9, 5, 3), (9, 5, 3)
    rows["a"] = (1000, 2000, 3000)
    table = hqr.launch_table(rows, np.array([2, 0]), 77)
    head = table[:hqr.HEAD.itemsize].view(hqr.HEAD)[0]
    assert (head["num_recs"], head["num_inst"], head["ticket"]) == \
        (2, 11, 77)
    recs = table[hqr.HEAD.itemsize:].view(hqr.REC)[:2]
    assert list(recs["a"]) == [3000, 1000] and list(recs["inst"]) == [0, 7]


def test_qr_flops():
    assert hqr.qr_flops(192, 192) == 8 * 192 ** 3 // 3
    assert hqr.qr_flops(10, 4) == 4 * 10 * 16 - 4 * 64 // 3


def test_qr_q_on_cpu_is_torch_linalg_qr():
    a = torch.randn(3, 12, 12, generator=torch.Generator().manual_seed(11))
    x = a.clone()
    assert torch.equal(ops.qr_q(x), torch.linalg.qr(a)[0])
    assert torch.equal(x, a)                          # left as it was
    assert torch.equal(ops.qr_q(a[0]), torch.linalg.qr(a[0])[0])


def test_launch_counter_in_snapshot():
    assert ("householder_qr_group",
            "repro_torch.kernels.householder_qr.kernel") in \
        counters.LAUNCH_COUNTERS
    snap = counters.snapshot()
    assert snap["launches.householder_qr_group"] == \
        hqr.householder_qr_group.launches


def test_refresh_groups_rule():
    assert soap.refresh_groups([4, 9, 1], whole=True) == [[0, 1, 2]]
    assert soap.refresh_groups([], whole=False) == [[]]
    # at most twice the largest side's elements a group, in order
    assert soap.refresh_groups([4, 9, 1, 9, 9, 2, 16], whole=False) == [
        [0, 1, 2, 3, 4], [5, 6]]
    assert soap.refresh_groups([5, 5, 5], whole=False) == [[0, 1], [2]]


def _soap_refresh(monkeypatch, state_dtype, on_kernel):
    """One SOAP step at its refresh on three leaves, the kernel's launcher
    stubbed (each product overwritten with its LAPACK Q) and the routing
    answered by ``on_kernel``; returns the launcher's calls (the sides'
    sizes) and the new state."""
    calls = []

    def launch_stub(mats):
        calls.append([m.shape[-1] for m in mats])
        for m in mats:
            m.copy_(torch.linalg.qr(m)[0])
        return mats

    monkeypatch.setattr(soap, "householder_qr_group", launch_stub)
    monkeypatch.setattr(soap, "_on_kernel", lambda qs: on_kernel)
    gen = torch.Generator().manual_seed(13)
    params = {"a": torch.randn(2, 16, 8, generator=gen),
              "b": torch.randn(2, 16, 16, generator=gen),
              "c": torch.randn(2, 8, 16, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    opt = soap.make(state_dtype=state_dtype)
    _, new = opt.update(grads, opt.init(params, lead=1), params, 0, lead=1)
    return calls, new


@pytest.mark.parametrize("state_dtype,want", [
    ("float32", [[16, 8, 16, 16, 8, 16]]),
    ("bfloat16", [[16, 8], [16, 16], [8, 16]]),
])
def test_refresh_calls_the_qr_by_group(monkeypatch, state_dtype, want):
    """SOAP's QR refresh with the launcher stubbed: one call over every
    side at f32 state, groups of at most twice the largest product at
    bf16; the Q's land on their sides."""
    calls, new = _soap_refresh(monkeypatch, state_dtype, on_kernel=True)
    assert calls == want
    for leaf in new["mat"].values():
        for q in ("QL", "QR"):
            x = leaf[q].float()
            assert leaf[q].dtype == getattr(torch, state_dtype)
            assert float((x.mT @ x - torch.eye(x.shape[-1])).abs().max()) \
                < 5e-2


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_refresh_sends_groups_the_kernel_does_not_take_to_qr_q(
        monkeypatch, state_dtype):
    """A group the kernel does not take goes side by side to
    ``torch.linalg.qr``: no launch, and the same state as the kernel's
    route where both give LAPACK's Q."""
    calls, lib = _soap_refresh(monkeypatch, state_dtype, on_kernel=False)
    assert calls == []
    _, kern = _soap_refresh(monkeypatch, state_dtype, on_kernel=True)
    for k, leaf in lib["mat"].items():
        for q in ("QL", "QR"):
            assert torch.equal(leaf[q], kern["mat"][k][q])


def test_on_kernel_asks_only_for_plain_cuda_tensors(monkeypatch):
    def never(qs):
        raise AssertionError("takes_group asked for CPU tensors")

    monkeypatch.setattr(soap, "takes_group", never)
    assert soap._on_kernel([torch.eye(3)]) is False
    assert soap._on_kernel([]) is False
