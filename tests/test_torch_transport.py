"""The port's wire codecs against the JAX package: every codec spec in
{dense, lowrank_svd, svd, power_sketch, qblock, lowrank_svd+qblock,
power_sketch+qblock} on the f32 and the bf16 wire — wire bytes, the
roundtrip, the fused ``accumulate`` (with and without ``carry``) and
``sq_norms`` — plus the low-rank flushes of ``kernels/fused_agg/ops.py``,
the leaf rule (small leaves pass through dense), chains, bf16 leaves on
the int8 wire, and the transport's resolution and byte accounting.

Inputs are numpy-seeded client-stacked trees whose matrices have a clear
spectral gap at the test rank (singular values 8, 6, 4, then <= 0.4), so
the rank-r truncation is well posed.  ``power_sketch``'s Omega is the
reference's own ``jax.random`` draw, injected through
``lowrank.sketch_omega``; SVD and QR factors are compared only through
their reconstructions (their signs are arbitrary).

Tolerances:
  * wire bytes: exact, against ``wire_bytes(jax.eval_shape(encode))`` of
    one client's tree.
  * dense and qblock (f32 and bf16 wire): decode bitwise; ``accumulate``
    and ``sq_norms`` 1e-6 relative (f32 sums in another order).
  * lowrank_svd, svd, power_sketch on the f32 wire: reconstructions
    within 1e-5 of the matrices' magnitude (LAPACK's SVD/QR in two
    builds, f32), the fused flush and the squared norms within 1e-5
    relative.
  * the bf16 wire and the chains with qblock: a factor one f32 ulp off
    at a rounding tie moves by one bf16 ulp or one int8 quantum, so
    reconstructions and flushes are held to one quantum of every factor
    carried through U·diag(s)·Vᵀ (or Q·B), from the message's own scales
    (qblock) or magnitudes (bf16), plus the f32 term; squared norms to 1%
    (one quantum of a factor moves a norm by ~1e-3 relative).
  * ``carry``: bitwise ``carry + accumulate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transport as JT
from repro.kernels.fused_agg import ref as jax_fa_ref
from repro_torch.convert import params_from_numpy
from repro_torch.core import transport as T
from repro_torch.core.transport import lowrank
from repro_torch.kernels.fused_agg import ops as fused_ops
from repro_torch.utils.tree import tree_flatten_with_path, tree_get

RANK = 3
S = 4
W = np.asarray([1.0, 0.5, 0.25, 0.8], np.float32)
SPECS = ["dense", "lowrank_svd", "svd", "power_sketch", "qblock",
         "lowrank_svd+qblock", "power_sketch+qblock"]
WIRES = ["f32", "bf16"]


def _gapped(r, shape):
    """Matrices (batched over the leading dims) with singular values
    8, 6, 4, then 0.4 * 0.8^k: a clear gap after the third."""
    *_, m, n = shape
    out = np.empty(shape, np.float32)
    flat = out.reshape(-1, m, n)
    k = min(m, n)
    sig = np.concatenate([[8.0, 6.0, 4.0], 0.4 * 0.8 ** np.arange(k - 3)])
    for i in range(flat.shape[0]):
        u, _ = np.linalg.qr(r.standard_normal((m, k)))
        v, _ = np.linalg.qr(r.standard_normal((n, k)))
        flat[i] = (u * sig) @ v.T
    return out


def _stacked(seed, s=S):
    """Per-client leaves: two compressible at rank 3 (a matrix and a
    batch of three), a vector and a 2x3 matrix that pass through dense."""
    r = np.random.default_rng(seed)
    return {"L": _gapped(r, (s, 16, 12)), "stack": _gapped(r, (s, 3, 10, 9)),
            "vec": r.standard_normal((s, 7)).astype(np.float32),
            "tiny": r.standard_normal((s, 2, 3)).astype(np.float32)}


# the port's own draw, kept before the autouse fixture swaps in JAX's
PORT_OMEGA = lowrank.sketch_omega


def _jax_omega(n, rank, device):
    """The reference's Omega (``lowrank.py:123``), through numpy."""
    o = jax.random.normal(jax.random.key(0xC0DEC), (n, rank), jnp.float32)
    return torch.from_numpy(np.array(o)).to(device)


@pytest.fixture(autouse=True)
def reference_omega(monkeypatch):
    monkeypatch.setattr(lowrank, "sketch_omega", _jax_omega)


def _codecs(spec, wire, rank=RANK):
    jc = JT.resolve_codec(spec, JT.TransportConfig(
        rank=rank, wire_dtype=wire, use_pallas=False))
    tc = T.resolve_codec(spec, T.TransportConfig(rank=rank, wire_dtype=wire))
    return jc, tc


def _t(tree):
    return params_from_numpy(tree, "cpu")


def _np(x):
    return x.to(torch.float32).numpy()


def _quantum_tol(tc, tmsg, wire):
    """Per leaf and client: one quantum of each factor carried through
    the reconstruction, first order (0 for dense leaves).  The quantum is
    the largest int8 step (qblock scale) of the factor for a chain, one
    bf16 ulp of its largest entry (2^-7 of it) on the bf16 wire."""
    tols = {}
    chained = isinstance(tc, T.Chain)
    inner = tc._peel(tmsg).leaves if chained else tmsg.leaves
    for path, fac in tree_flatten_with_path(inner):
        if fac.kind not in ("lowrank", "sketch"):
            tols[path] = np.zeros(S, np.float32)
            continue
        a = {k: v.abs().to(torch.float32).reshape(S, -1).amax(-1).numpy()
             for k, v in fac.parts.items()}
        if chained:
            q = {k: m.parts["scale"].reshape(S, -1).amax(-1).numpy()
                 for k, m in tree_get(tmsg.leaves, path).items()}
        else:
            q = {k: v * (2.0 ** -7 if wire == "bf16" else 0.0)
                 for k, v in a.items()}
        if fac.kind == "lowrank":
            tol = RANK * (q["u"] * a["s"] * a["vt"] + a["u"] * q["s"]
                          * a["vt"] + a["u"] * a["s"] * q["vt"])
        else:
            tol = RANK * (q["q"] * a["b"] + a["q"] * q["b"])
        tols[path] = 1.1 * tol
    return tols


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("spec", SPECS)
def test_wire_bytes_match_the_reference_exactly(spec, wire):
    tree = _stacked(0)
    jc, tc = _codecs(spec, wire)
    one = jax.tree.map(lambda x: x[0], tree)
    want = JT.wire_bytes(jax.eval_shape(jc.encode, one))
    got = T.wire_bytes(tc.encode(_t(jax.tree.map(lambda x: x[:1], tree))))
    assert got == want
    assert tc.name == jc.name and tc.lossless == jc.lossless


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("spec", SPECS)
def test_roundtrip_accumulate_and_sq_norms_match_the_reference(spec, wire):
    tree = _stacked(1)
    jc, tc = _codecs(spec, wire)
    jmsg = jax.vmap(jc.encode)(tree)
    tmsg = tc.encode(_t(tree))
    want_dec = jax.vmap(jc.decode)(jmsg)
    got_dec = tc.decode(tmsg)
    want_acc = jc.accumulate(jmsg, jnp.asarray(W))
    got_acc = tc.accumulate(tmsg, torch.from_numpy(W))
    chained = "+" in spec
    quantized = chained or wire == "bf16"
    tols = _quantum_tol(tc, tmsg, wire)
    for path, x in tree_flatten_with_path(_t(tree)):
        key = path[0]
        w_dec, g_dec = np.asarray(want_dec[key]), got_dec[key]
        assert g_dec.dtype == x.dtype and tuple(g_dec.shape) == w_dec.shape
        w_acc, g_acc = np.asarray(want_acc[key]), _np(got_acc[key])
        assert g_acc.shape == w_acc.shape
        err = np.abs(_np(g_dec) - w_dec).reshape(S, -1).max(-1)
        acc_err = np.abs(g_acc - w_acc).max()
        mag = np.abs(w_dec).max()
        if spec in ("dense", "qblock") or key in ("vec", "tiny"):
            np.testing.assert_array_equal(_np(g_dec), w_dec, err_msg=key)
            assert acc_err <= 1e-6 * np.abs(w_acc).max(), key
        else:
            tol = tols[path] + 1e-5 * mag
            assert np.all(err <= tol), (key, err, tol)
            assert acc_err <= float(W @ tol), key
    rtol = 1e-6 if spec in ("dense", "qblock") else 1e-2 if quantized \
        else 1e-5
    np.testing.assert_allclose(tc.sq_norms(tmsg).numpy(),
                               np.asarray(jc.sq_norms(jmsg)), rtol=rtol)


@pytest.mark.parametrize("spec", SPECS)
def test_carry_folds_bitwise_and_none_adds_no_zero(spec):
    tree = _stacked(2)
    tc = T.resolve_codec(spec, T.TransportConfig(rank=RANK))
    tmsg = tc.encode(_t(tree))
    w = torch.from_numpy(W)
    out = tc.accumulate(tmsg, w)
    carry = {k: torch.from_numpy(np.random.default_rng(5).standard_normal(
        v.shape).astype(np.float32)) for k, v in out.items()}
    folded = tc.accumulate(tmsg, w, carry=carry)
    for k in out:
        torch.testing.assert_close(folded[k], carry[k] + out[k], rtol=0,
                                   atol=0)
        leaf = tmsg.leaves[k]
        if spec == "dense":
            torch.testing.assert_close(
                tc.accumulate_leaf(leaf, w, carry=carry[k]),
                carry[k] + out[k], rtol=0, atol=0)


@pytest.mark.parametrize("spec,kind", [("lowrank_svd", "lowrank"),
                                       ("power_sketch", "sketch")])
def test_small_leaves_pass_through_dense_and_both_kinds_appear(spec, kind):
    tc = T.resolve_codec(spec, T.TransportConfig(rank=RANK))
    msg = tc.encode(_t(_stacked(3)))
    kinds = {k: m.kind for k, m in msg.leaves.items()}
    assert kinds == {"L": kind, "stack": kind, "vec": "dense",
                     "tiny": "dense"}
    u = msg.leaves["stack"].parts["u" if kind == "lowrank" else "q"]
    assert tuple(u.shape) == (S, 3, 10, RANK)
    # at rank 9 the 16x12 matrix still compresses, the 10x9 batch does not
    msg = T.resolve_codec(spec, T.TransportConfig(rank=9)).encode(
        _t(_stacked(3)))
    assert msg.leaves["L"].kind == kind and msg.leaves["stack"].kind == "dense"


def test_chain_ships_fewer_bytes_than_lowrank_and_stays_near_it():
    """The reference's own check (tests/test_transport.py): quantized
    factors ship fewer bytes, and decode within 0.2 of the pure low-rank
    roundtrip."""
    r = np.random.default_rng(4)
    tree = _t({"L": r.standard_normal((1, 32, 24)).astype(np.float32)})
    cfg = T.TransportConfig(rank=4)
    chain = T.resolve_codec("lowrank_svd+qblock", cfg)
    lr = T.resolve_codec("lowrank_svd", cfg)
    assert isinstance(chain, T.Chain) and not chain.lossless
    assert chain.name == "lowrank_svd+qblock"
    msg = chain.encode(tree)
    assert T.wire_bytes(msg) < T.wire_bytes(lr.encode(tree))
    # the envelopes ride as metadata: no payload, no bytes
    frame, = msg.envelopes
    assert frame["L"].kind == "lowrank" and frame["L"].parts is None
    err = (chain.decode(msg)["L"] - lr.roundtrip(tree)["L"]).abs().max()
    assert float(err) < 0.2


def test_fused_agg_ops_match_the_reference():
    r = np.random.default_rng(6)

    def f(*shape):
        return r.standard_normal(shape).astype(np.float32)

    u, s, vt = f(4, 3, 10, 2), f(4, 3, 2), f(4, 3, 2, 9)
    w = np.asarray([1.0, 0.3, 0.0, 2.0], np.float32)
    want = jax_fa_ref.lowrank_accumulate(u, s, vt, w)
    got = fused_ops.lowrank_accumulate(*map(torch.from_numpy, (u, s, vt, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    q, b = f(4, 16, 3), f(4, 3, 12)
    want = jax_fa_ref.sketch_accumulate(q, b, w)
    got = fused_ops.sketch_accumulate(*map(torch.from_numpy, (q, b, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_qblock_quantizes_bf16_leaves_as_f32_and_decodes_to_bf16():
    """A chain's bf16 factors on the int8 wire: quantized from their f32
    values, as the reference's ``ref.py`` casts them."""
    r = np.random.default_rng(7)
    x = r.standard_normal((S, 300)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jmsg = jax.vmap(JT.QBlock(use_pallas=False).encode)(
        {"a": jnp.asarray(x, jnp.bfloat16)})
    tmsg = T.QBlock().encode({"a": xb})
    np.testing.assert_array_equal(tmsg.leaves["a"].parts["q"].numpy(),
                                  np.asarray(jmsg.leaves[0].parts["q"]))
    np.testing.assert_array_equal(tmsg.leaves["a"].parts["scale"].numpy(),
                                  np.asarray(jmsg.leaves[0].parts["scale"]))
    got = T.QBlock().decode(tmsg)["a"]
    want = jax.vmap(JT.QBlock(use_pallas=False).decode)(jmsg)["a"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_resolution_validation_and_round_bytes_match_the_reference():
    assert T.registered_codecs() == JT.registered_codecs()
    for spec in SPECS + ["svd+qblock", "dense+qblock"]:
        T.validate_codec_spec(spec)
        assert T.resolve_codec(spec).name == JT.resolve_codec(spec).name
    for bad in ("sketch", "lowrank_svd+", "qblock+nope"):
        with pytest.raises(T.UnknownCodecError):
            T.validate_codec_spec(bad)
    with pytest.raises(ValueError, match="wire_dtype"):
        T.TransportConfig(wire_dtype="fp8")
    assert T.Dense().lossless and not T.Dense("bf16").lossless
    assert T.Transport(T.Dense("bf16"), T.Dense()).feedback_active
    assert T.wire_cast(torch.arange(3), "bf16").dtype == torch.int64
    params = {"w": np.zeros((12, 20), np.float32),
              "b": np.zeros((77,), np.float32)}
    theta = {"h": params}
    for spec in ("lowrank_svd", "power_sketch+qblock"):
        for wire in WIRES:
            jc, tc = _codecs(spec, wire, rank=4)
            want = JT.Transport(JT.Dense(wire), jc).round_bytes(params, theta)
            got = T.Transport(T.Dense(wire), tc).round_bytes(_t(params),
                                                             _t(theta))
            assert got == want, (spec, wire)


def test_sketch_omega_is_drawn_once_per_shape_and_device():
    a = PORT_OMEGA(12, 3, "cpu")
    assert PORT_OMEGA(12, 3, torch.device("cpu")) is a
    want = torch.randn((12, 3), generator=torch.Generator().manual_seed(
        lowrank.OMEGA_SEED))
    assert torch.equal(a, want)
    assert PORT_OMEGA(12, 4, "cpu").shape == (12, 4)
