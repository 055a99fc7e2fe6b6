"""The port's int8 wire against the JAX package: the ``quantize`` and
``dequant_accumulate`` kernels' plain versions (against ``ref.py`` and
the Pallas kernels in interpret mode), the ``QBlock`` codec on a
cohort-stacked tree (encode, decode, accumulate, sq_norms, wire bytes),
error feedback (``encode_with_feedback`` and the stacked residual
state), the wire-native drift of ``aggregate_wire`` with a lossy theta
codec, and the config's validation.  (The 3-round qblock + error
feedback history is in tests/test_torch_sophia.py.)

Tolerances:
  * quantize: q and scale bitwise equal to ``ref.py`` — inputs include
    exact k + 0.5 ties (round half to even), all-zero blocks and ragged
    tails.  Against the interpret-mode Pallas kernel, scales within one
    ulp (XLA's jit divides by 127 as a multiply by 1/127) and q equal
    wherever the scales are.
  * dequantize: bitwise (one f32 product per element on both sides).
  * dequant_accumulate / accumulate: 4 B u sum_i |w_i s_i q_i| per
    element (u = 2^-24): B f32 products summed in another order.
  * sq_norms and the drift: 1e-5 relative (sums of squares in another
    order).  Error-feedback residuals: 1e-6 absolute (the same f32
    algebra around bitwise-equal messages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transport as JT
from repro.core.engine import (
    AggregationConfig as JaxAggCfg, aggregate_wire as jax_aggregate_wire,
)
from repro.kernels.fused_agg import ref as jax_fa_ref
from repro.kernels.fused_agg.kernel import (
    dequant_accumulate as jax_dequant_pallas,
)
from repro.kernels.qblock import ref as jax_qb_ref
from repro.kernels.qblock.kernel import quantize as jax_quantize_pallas
from repro_torch.convert import params_from_numpy
from repro_torch.core import transport as T
from repro_torch.core.algorithms import (
    EF_STATE, AlgorithmSpec, build_round_fn, resolve,
    round_client_state_spec,
)
from repro_torch.core.engine import AggregationConfig, aggregate_wire
from repro_torch.fed.rounds import FedConfig
from repro_torch.kernels.fused_agg.kernel import (
    dequant_accumulate, dequant_accumulate_plain,
)
from repro_torch.kernels.qblock.kernel import (
    dequantize, quantize, quantize_plain,
)
from repro_torch.optim import sophia
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

U = 2.0 ** -24


def _tied_rows(rows, n, block, seed):
    """(rows, n) f32 whose blocks hit every case: a block whose scale is
    exactly 2^-3 and whose entries are exact k + 0.5 multiples of it
    (round-half-to-even ties), an all-zero block, and random blocks; the
    last block of each row is ragged when n % block != 0."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((rows, n)) * 3.0).astype(np.float32)
    for i in range(rows):
        b0 = min(block, n)
        ties = (r.integers(-126, 126, b0) + 0.5) * 0.125
        ties[0] = 127 * 0.125                    # amax -> scale = 2^-3
        x[i, :b0] = ties.astype(np.float32)
        if n > 2 * block:
            x[i, block:2 * block] = 0.0          # an all-zero block
    return x


def _ref_rows(x, block):
    """The reference's per-client quantize (ref.py), row by row, with q
    trimmed to the n values that ship."""
    n = x.shape[1]
    qs, ss = [], []
    for row in x:
        q, s = jax_qb_ref.quantize(jnp.asarray(row), block=block)
        qs.append(np.asarray(q).reshape(-1)[:n])
        ss.append(np.asarray(s))
    return np.stack(qs), np.stack(ss)


@pytest.mark.parametrize("rows,n,block", [(1, 300, 128), (3, 256, 128),
                                          (5, 1000, 128), (2, 77, 32),
                                          (4, 10, 8)])
def test_quantize_plain_bitwise_matches_ref(rows, n, block):
    x = _tied_rows(rows, n, block, n)
    q, s = quantize(torch.from_numpy(x), block=block)
    want_q, want_s = _ref_rows(x, block)
    assert q.dtype == torch.int8 and tuple(q.shape) == (rows, n)
    assert tuple(s.shape) == (rows, -(-n // block))
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(s.numpy(), want_s)
    # ties went to the even neighbour, not away from zero
    xs = x[0, :min(block, n)] / want_s[0, 0]
    assert np.any(np.abs(xs - np.round(xs)) == 0.5)
    assert np.array_equal(q.numpy()[0, :min(block, n)],
                          np.round(xs).astype(np.int8))


@pytest.mark.parametrize("n", [300, 4096])
def test_quantize_plain_matches_pallas_interpret(n):
    """Against the Pallas kernel in interpret mode, which XLA compiles:
    XLA's jit turns ``amax / 127`` (a division by a constant) into
    ``amax * (1/127)``, one ulp off the division in a few percent of the
    blocks (ROADMAP queue 3).  Blocks whose scales agree have bitwise
    equal q; the others differ by that one ulp and q by at most 1."""
    x = _tied_rows(2, n, 128, 7 + n)
    q, s = quantize_plain(torch.from_numpy(x), block=128)
    for i in range(2):
        pq, ps = jax_quantize_pallas(jnp.asarray(x[i]), block=128,
                                     interpret=True)
        pq = np.asarray(pq).reshape(-1)[:n].astype(np.int32)
        ps = np.asarray(ps)
        got_q, got_s = q.numpy()[i].astype(np.int32), s.numpy()[i]
        assert np.all(np.abs(got_s.view(np.int32) - ps.view(np.int32)) <= 1)
        same = np.repeat(got_s == ps, 128)[:n]
        np.testing.assert_array_equal(got_q[same], pq[same])
        assert np.all(np.abs(got_q - pq) <= 1)
        # the reciprocal form reproduces the jitted scale exactly
        amax = np.abs(np.pad(x[i], (0, -n % 128)).reshape(-1, 128)).max(1)
        np.testing.assert_array_equal(
            np.maximum(amax * np.float32(1 / 127), np.float32(1e-12)), ps)


def test_dequantize_bitwise_matches_ref():
    x = _tied_rows(3, 500, 128, 3)
    q, s = quantize_plain(torch.from_numpy(x), block=128)
    got = dequantize(q, s, 128)
    for i in range(3):
        qq = np.pad(q.numpy()[i], (0, 512 - 500)).reshape(4, 128)
        want = jax_qb_ref.dequantize(jnp.asarray(qq), jnp.asarray(s[i]),
                                     (500,))
        np.testing.assert_array_equal(got.numpy()[i], np.asarray(want))
    assert float((got - torch.from_numpy(x)).abs().max()) <= float(
        s.max()) / 2


def _accumulate_bound(q, s, w, block):
    n = q.shape[1]
    ws = np.abs(w[:, None] * s)
    per = np.repeat(ws, block, axis=1)[:, :n] * np.abs(q.astype(np.float32))
    return 4 * q.shape[0] * U * per.sum(0) + 1e-30


@pytest.mark.parametrize("b,n", [(1, 128), (5, 1000), (3, 4096), (2, 77)])
def test_dequant_accumulate_plain_matches_ref_and_pallas(b, n):
    r = np.random.default_rng(b * n)
    x = (r.standard_normal((b, n)) * 2).astype(np.float32)
    q, s = quantize_plain(torch.from_numpy(x), block=128)
    w = r.uniform(0.2, 1.5, b).astype(np.float32)
    got = dequant_accumulate(q, s, torch.from_numpy(w), block=128).numpy()
    assert got.shape == (n,)
    nb = s.shape[1]
    q3 = np.pad(q.numpy(), ((0, 0), (0, nb * 128 - n))).reshape(b, nb, 128)
    want_ref = jax_fa_ref.dequant_accumulate(jnp.asarray(q3),
                                             jnp.asarray(s.numpy()),
                                             jnp.asarray(w))
    want_pal = jax_dequant_pallas(jnp.asarray(q3), jnp.asarray(s.numpy()),
                                  jnp.asarray(w), interpret=True)
    bound = _accumulate_bound(q.numpy(), s.numpy(), w, 128)
    for want in (want_ref, want_pal):
        want = np.asarray(want).reshape(-1)[:n]
        assert np.all(np.abs(got - want) <= bound)


def test_kernel_wrappers_validate_and_run_plain_on_cpu():
    x = torch.ones(2, 10)
    before = (quantize.launches, dequant_accumulate.launches)
    q, s = quantize(x, block=4)
    assert torch.equal(dequant_accumulate(q, s, torch.ones(2), block=4),
                       dequant_accumulate_plain(q, s, torch.ones(2),
                                                block=4))
    assert (quantize.launches, dequant_accumulate.launches) == before
    with pytest.raises(ValueError, match="rows, n"):
        quantize(torch.ones(10))
    with pytest.raises(ValueError, match="shape mismatch"):
        dequant_accumulate(q, s, torch.ones(2), block=8)
    with pytest.raises(TypeError, match="int8"):
        dequant_accumulate(q.float(), s, torch.ones(2), block=4)
    meta = torch.ones(2, 10, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        quantize(meta, block=4)


# ------------------------------------------------------------------ codec

STACK = {"w": (4, 12, 20), "stem": (4, 3, 3, 2, 8), "gn_scale": (4, 8),
         "blocks": [{"b1": (4, 200)}]}


def _stacked(seed, shapes=STACK):
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (r.standard_normal(s) * 0.1).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def _jax_codec():
    return JT.QBlock(block=128, use_pallas=False)


def test_qblock_codec_matches_jax_on_stacked_tree():
    tree = _stacked(0)
    jc, tc = _jax_codec(), T.resolve_codec("qblock")
    assert isinstance(tc, T.QBlock) and tc.block == 128 and not tc.lossless
    jmsg = jax.vmap(jc.encode)(tree)
    tmsg = tc.encode(params_from_numpy(tree, "cpu"))
    assert T.wire_bytes(tmsg) == JT.wire_bytes(jmsg)
    for jl, (path, tl) in zip(jmsg.leaves, tree_flatten_with_path(
            tmsg.leaves)):
        assert tl.kind == "qblock" and tl.extra == jl.extra == 128
        np.testing.assert_array_equal(tl.parts["q"].numpy(),
                                      np.asarray(jl.parts["q"]),
                                      err_msg=str(path))
        np.testing.assert_array_equal(tl.parts["scale"].numpy(),
                                      np.asarray(jl.parts["scale"]))
    # decode: bitwise
    want = jax.vmap(jc.decode)(jmsg)
    got = tc.decode(tmsg)
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # accumulate: within the f32 summation bound, per leaf
    w = np.asarray([1.0, 0.5, 0.25, 0.8], np.float32)
    want = jc.accumulate(jmsg, jnp.asarray(w))
    got = tc.accumulate(tmsg, torch.from_numpy(w))
    for wl, gl, ml in zip(jax.tree.leaves(want), tree_leaves(got),
                          tree_leaves(tmsg.leaves)):
        bound = _accumulate_bound(ml.parts["q"].numpy(),
                                  ml.parts["scale"].numpy(), w, 128)
        assert tuple(gl.shape) == wl.shape
        assert np.all(np.abs(gl.numpy().reshape(-1)
                             - np.asarray(wl).reshape(-1)) <= bound)
    # sq_norms: per-client, wire-native
    np.testing.assert_allclose(tc.sq_norms(tmsg).numpy(),
                               np.asarray(jc.sq_norms(jmsg)), rtol=1e-5)


def test_dense_sq_norms_are_the_clients_squared_norms():
    """The base (decode-then-reduce) ``sq_norms`` that a lossless codec
    inherits: one squared norm per client over every leaf."""
    tree = params_from_numpy(_stacked(3), "cpu")
    got = T.Dense().sq_norms(T.Dense().encode(tree))
    want = sum((x.reshape(4, -1) ** 2).sum(-1) for x in tree_leaves(tree))
    assert tuple(got.shape) == (4,)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_qblock_blocks_never_span_clients():
    """A stacked (S, 192) leaf: each client's row gets its own two blocks,
    as one client's encode under the reference's vmap."""
    x = np.zeros((3, 192), np.float32)
    x[0] = 1.0
    x[2] = 100.0
    msg = T.QBlock().encode({"a": torch.from_numpy(x)})
    s = msg.leaves["a"].parts["scale"].numpy()
    assert s.shape == (3, 2)
    np.testing.assert_array_equal(s[1], np.float32(1e-12))
    assert np.all(s[0] == np.float32(1.0) / np.float32(127.0))


def test_round_bytes_match_jax_for_qblock():
    params = {"w": np.zeros((12, 20), np.float32),
              "b": np.zeros((77,), np.float32)}
    jtr = JT.Transport(delta=_jax_codec(), theta=_jax_codec())
    ttr = T.Transport(delta=T.QBlock(), theta=T.QBlock())
    theta = {"h": params}
    want = jtr.round_bytes(params, theta)
    got = ttr.round_bytes(params_from_numpy(params, "cpu"),
                          params_from_numpy(theta, "cpu"))
    assert got == want == 2 * ((240 + 4 * 2) + (77 + 4))


# --------------------------------------------------------- error feedback

def test_encode_with_feedback_matches_jax():
    tree = _stacked(1)
    residual = jax.tree.map(lambda x: x * 0.05, _stacked(2))
    jc, tc = _jax_codec(), T.QBlock()
    jmsg, jdec, jres = jax.vmap(
        lambda t, r: JT.encode_with_feedback(jc, t, r))(tree, residual)
    tmsg, tdec, tres = T.encode_with_feedback(
        tc, params_from_numpy(tree, "cpu"),
        params_from_numpy(residual, "cpu"))
    assert T.wire_bytes(tmsg) == JT.wire_bytes(jmsg)
    for w, g in zip(jax.tree.leaves(jdec), tree_leaves(tdec)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for w, g in zip(jax.tree.leaves(jres), tree_leaves(tres)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    msg, dec, res = T.encode_with_feedback(tc, params_from_numpy(tree,
                                                                 "cpu"))
    assert dec is None and res is None
    assert T.wire_bytes(msg) == T.wire_bytes(tmsg)


def test_ef_state_gathers_and_scatters_cohort_rows():
    params = {"a": torch.zeros(3, 2), "b": [torch.zeros(4)]}
    state = T.ef_init(params, 6)
    assert tuple(state["a"].shape) == (6, 3, 2)
    assert state["a"].dtype == torch.float32
    cohort = torch.tensor([4, 1])
    view = T.ef_view(state, cohort)
    new = {"a": torch.ones(2, 3, 2), "b": [torch.full((2, 4), 2.0)]}
    out = EF_STATE.server_update(state, cohort, new, 6)
    assert bool((out["a"][4] == 1).all()) and bool((out["b"][0][1] == 2).all())
    assert not bool(out["a"][[0, 2, 3, 5]].any())
    assert not bool(view["a"].any())          # the view was a copy
    # only a lossy delta codec with feedback on carries state
    spec = resolve("fedpac_sophia")
    lossy = spec.make_transport(delta_codec="qblock")
    assert round_client_state_spec(spec, lossy) is EF_STATE
    off = spec.make_transport(delta_codec="qblock", error_feedback=False)
    assert round_client_state_spec(spec, off) is None
    assert round_client_state_spec(spec, spec.make_transport()) is None
    with pytest.raises(ValueError, match="n_clients"):
        build_round_fn(spec, lambda p, b: 0.0, sophia.make(), lr=0.1,
                       local_steps=1, transport=lossy)


# ------------------------------------------------------ wire-native drift

def test_aggregate_wire_lossy_theta_matches_jax():
    s = 4
    r = np.random.default_rng(5)

    def f(*shape):
        return r.standard_normal(shape).astype(np.float32)

    params = {"a": f(12, 20), "b": f(77)}
    theta = {"h": {"a": np.abs(f(12, 20)), "b": np.abs(f(77))}}
    g = {"a": f(12, 20), "b": f(77)}
    deltas = {"a": f(s, 12, 20) * 0.01, "b": f(s, 77) * 0.01}
    thetas = {"h": {"a": np.abs(f(s, 12, 20)), "b": np.abs(f(s, 77))}}
    w = np.ones((s,), np.float32)
    jtr = JT.Transport(delta=_jax_codec(), theta=_jax_codec())
    jcfg = JaxAggCfg(lr=0.02, local_steps=5, align=True)
    want = jax_aggregate_wire(
        params, theta, g, jax.vmap(jtr.delta.encode)(deltas),
        jnp.asarray(w), jcfg, jtr,
        tmsgs=jax.vmap(jtr.theta.encode)(thetas))
    ttr = T.Transport(delta=T.QBlock(), theta=T.QBlock())
    cfg = AggregationConfig(lr=0.02, local_steps=5, align=True)
    tp = lambda t: params_from_numpy(t, "cpu")  # noqa: E731
    got = aggregate_wire(
        tp(params), tp(theta), tp(g), ttr.delta.encode(tp(deltas)),
        torch.from_numpy(w), cfg, ttr, tmsgs=ttr.theta.encode(tp(thetas)))
    for i in range(3):
        for wl, gl in zip(jax.tree.leaves(want[i]), tree_leaves(got[i])):
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                       rtol=1e-5, atol=1e-6)
    for k in ("drift", "norm_drift", "freshness"):
        np.testing.assert_allclose(float(got[3][k]), float(want[3][k]),
                                   rtol=1e-5)
    assert float(got[3]["drift"]) > 0
    assert got[4]["thetas"] is None


# ----------------------------------------------------------------- config

def test_fedconfig_codec_fields_validate_and_reach_the_transport(
        monkeypatch):
    cfg = FedConfig(device="cpu", delta_codec="qblock", theta_codec="qblock",
                    qblock_size=32, error_feedback=False)
    tr = cfg.make_transport(resolve("fedpac_sophia"))
    assert isinstance(tr.delta, T.QBlock) and tr.delta.block == 32
    assert isinstance(tr.theta, T.QBlock) and not tr.feedback_active
    assert isinstance(FedConfig(device="cpu").make_transport(
        resolve("fedpac_soap")).delta, T.Dense)
    for bad in (dict(qblock_size=0), dict(hessian_freq=0)):
        with pytest.raises(ValueError):
            FedConfig(device="cpu", **bad)
    with pytest.raises(T.UnknownCodecError):
        FedConfig(device="cpu", delta_codec="lowrank_svd")
    with pytest.raises(T.UnknownCodecError):
        AlgorithmSpec(name="x", delta_upload="sketch")
    # the CUDA kernels take whole 128-element blocks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="multiple of 128"):
        FedConfig(qblock_size=64)
    assert FedConfig(qblock_size=256).qblock_size == 256
