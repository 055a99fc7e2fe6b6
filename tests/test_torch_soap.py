"""The port's SOAP (``repro_torch.optim.soap``) against
``repro.optim.soap``: K steps of ``update`` with per-step directions and
states compared, on the same numpy gradients.

Both sides warm-start from the same full-rank SPD L/R through
``set_precond``, so every QR refresh orthogonalises a full-rank product
and is well-posed.  (From the zero L/R of a fresh round the first refresh
orthogonalises the rank-deficient G G^T; the trailing columns of Q are
then set by roundoff in either implementation, and the bias-corrected
Adam step amplifies that roundoff to O(1).  No port can match that at a
tight tolerance; tests/test_torch_round.py compares whole rounds at an
eps that damps it.)

Tolerance: 2e-5 absolute + 1e-4 relative per element on directions and
every state leaf — LAPACK QRs and f32 products in other summation orders
on the two sides, over 4 steps and 2 refreshes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.algorithms import zero_theta as jax_zero_theta
from repro.models import vision as jv
from repro.optim import api as jax_api, soap as jax_soap
from repro_torch.convert import params_from_numpy
from repro_torch.core.algorithms import zero_theta
from repro_torch.optim import api, soap
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_leaves, tree_map,
)

K = 4
RTOL, ATOL = 1e-4, 2e-5

SHAPES = {
    "w": (12, 20),                # dense matrix
    "stem": (3, 3, 2, 8),         # HWIO conv -> (18, 8) matrix view
    "experts": (2, 10, 12),       # batched matrices
    "head": {"w": (20, 5)},       # Adam fallback (name)
    "bias": (20,),                # Adam fallback (rank)
}


def _params(seed, lead=()):
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: r.standard_normal((*lead, *s)).astype(np.float32), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))


def _spd(r, batch, n):
    a = r.standard_normal((*batch, n, n)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / n
            + 0.5 * np.eye(n, dtype=np.float32)).astype(np.float32)


def _spd_theta(jopt, params, seed):
    """A full-rank SPD L/R for every matrix leaf, in the reference's theta
    layout."""
    r = np.random.default_rng(seed)
    shapes = jopt.get_precond(jopt.init(params))
    return jax.tree.map(lambda x: _spd(r, x.shape[:-2], x.shape[-1]), shapes)


def _assert_close(want_tree, got_tree, what):
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = tree_flatten_with_path(got_tree)
    assert len(want) == len(got), what
    for (wp, w), (gp, g) in zip(want, got):
        w = np.asarray(w)
        g = g.detach().cpu().numpy()
        assert w.shape == g.shape, (what, gp)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {gp}")


def _run_both(kw):
    jopt = jax_soap.make(**kw)
    topt = soap.make(**kw)
    p = _params(0)
    theta = _spd_theta(jopt, p, 1)
    jst = jopt.set_precond(jopt.init(p), theta)
    tp = params_from_numpy(p, "cpu")
    tst = topt.set_precond(topt.init(tp), params_from_numpy(theta, "cpu"))
    jupd = jax.jit(jopt.update, static_argnames=("step",))
    r = np.random.default_rng(2)
    for k in range(K):
        g = jax.tree.map(lambda x: r.standard_normal(x.shape).astype(
            np.float32), p)
        jd, jst = jupd(g, jst, p, step=k)
        td, tst = topt.update(params_from_numpy(g, "cpu"), tst, tp, k)
        _assert_close(jd, td, f"direction step {k}")
        _assert_close(jst, tst, f"state step {k}")
    return jst, tst


@pytest.mark.parametrize("max_precond_dim", [8192, 15])
def test_soap_k_steps_match_jax_from_spd_warm_start(max_precond_dim):
    """Two-sided (8192), and one-sided at 15: (12, 20) keeps only L,
    (18, 8) only R, (10, 12) both."""
    kw = dict(precond_freq=2, max_precond_dim=max_precond_dim)
    jst, tst = _run_both(kw)
    st = tst["mat"]
    if max_precond_dim == 15:
        assert set(st["w"]) == {"L", "QL", "M", "V"}
        assert set(st["stem"]) == {"R", "QR", "M", "V"}
    assert set(st["experts"]) == {"L", "QL", "R", "QR", "M", "V"}
    assert st["head"]["w"] is None and st["bias"] is None
    assert tst["am"]["bias"] is not None and tst["am"]["w"] is None


def test_soap_weight_decay_and_default_eps_match_jax():
    _run_both(dict(precond_freq=3, weight_decay=0.01, b1=0.9, b2=0.99))


def test_soap_stacked_clients_match_jax_per_client():
    """One update over (S, ...) stacked trees (the round engine's layout)
    equals the reference run client by client; a per-client theta
    broadcasts over the client axis."""
    s = 3
    jopt = jax_soap.make(precond_freq=2)
    topt = soap.make(precond_freq=2)
    p = _params(0)
    stacked = _params(5, lead=(s,))
    theta = _spd_theta(jopt, p, 1)
    tst = topt.set_precond(
        topt.init(params_from_numpy(stacked, "cpu"), lead=1),
        params_from_numpy(theta, "cpu"))
    jupd = jax.jit(jopt.update, static_argnames=("step",))
    jsts = [jopt.set_precond(jopt.init(_pick(stacked, i)), theta)
            for i in range(s)]
    r = np.random.default_rng(3)
    for k in range(K):
        g = jax.tree.map(lambda x: r.standard_normal(x.shape).astype(
            np.float32), stacked)
        td, tst = topt.update(params_from_numpy(g, "cpu"), tst,
                              params_from_numpy(stacked, "cpu"), k, lead=1)
        for i in range(s):
            jd, jsts[i] = jupd(_pick(g, i), jsts[i], _pick(stacked, i),
                               step=k)
            _assert_close(jd, tree_map(lambda x: x[i], td),
                          f"direction {i} step {k}")
            _assert_close(jsts[i], tree_map(lambda x: x[i], tst),
                          f"state {i} step {k}")


def _pick(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


@pytest.fixture(scope="module")
def cnn_vit_params():
    cnn = jax.jit(lambda k: jv.init_cnn(k, n_classes=8, width=8, blocks=2))(
        jax.random.key(0))
    vit = jax.jit(lambda k: jv.init_vit(k, image_size=16, d_model=32,
                                        layers=2, n_classes=8)[0])(
        jax.random.key(0))
    return [cnn, vit]


@pytest.mark.parametrize("model", [0, 1], ids=["cnn", "vit"])
def test_matrix_mask_and_views_match_jax_per_client_and_stacked(
        cnn_vit_params, model):
    """Classification uses the per-client shape: a client-stacked HWIO conv
    (5-D) is still a conv, flattened to (k*k*c_in, c_out)."""
    p = cnn_vit_params[model]
    want = jax.tree.leaves(jax_api.matrix_mask(p))
    tp = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    stacked = params_from_numpy(jax.tree.map(
        lambda x: np.stack([np.asarray(x)] * 3), p), "cpu")
    assert tree_leaves(api.matrix_mask(tp)) == want
    assert tree_leaves(api.matrix_mask(stacked, lead=1)) == want
    if model == 0:
        assert want.count(True) == 3      # stem + two 1x1 skips
    else:
        assert want.count(True) == 8      # wqkv/wo/w1/w2 per block
    for (path, x), (_, xs) in zip(tree_flatten_with_path(tp),
                                  tree_flatten_with_path(stacked)):
        wm, wshape = jax_api.as_matrix(jnp.zeros(x.shape))
        m, shape = api.as_matrix(x)
        ms, shape_s = api.as_matrix(xs, lead=1)
        assert tuple(m.shape) == tuple(wm.shape), path
        assert tuple(ms.shape) == (3, *wm.shape), path
        assert (shape is None) == (wshape is None) == (shape_s is None)


def test_zero_theta_and_precond_round_trip_match_jax(cnn_vit_params):
    p = cnn_vit_params[0]
    jopt, topt = jax_soap.make(), soap.make()
    want = jax_zero_theta(jopt, p)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    got = zero_theta(topt, tp)
    _assert_close(want, got, "zero theta")
    theta = _spd_theta(jopt, p, 4)
    back = topt.get_precond(topt.set_precond(topt.init(tp),
                                             params_from_numpy(theta, "cpu")))
    _assert_close(theta, back, "set/get precond")


def test_soap_bf16_state_step_matches_jax():
    """One refresh step at ``state_dtype`` bfloat16 from the same bf16
    warm start: the port's grouped products read the stored bf16 factors
    and write the EMAs in bf16, the reference casts them around its f32
    products; factors (bf16 on both sides) and the update agree."""
    import torch
    jopt = jax_soap.make(precond_freq=2, state_dtype=jnp.bfloat16)
    topt = soap.make(precond_freq=2, state_dtype=torch.bfloat16)
    p = _params(0)
    theta = jax.tree.map(lambda x: np.asarray(
        jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)),
        _spd_theta(jopt, p, 1))
    jst = jopt.set_precond(jopt.init(p), theta)
    tp = params_from_numpy(p, "cpu")
    tst = topt.set_precond(topt.init(tp), params_from_numpy(theta, "cpu"))
    g = jax.tree.map(lambda x: np.random.default_rng(2).standard_normal(
        x.shape).astype(np.float32), p)
    jd, jst = jopt.update(g, jst, p, step=0)
    td, tst = topt.update(params_from_numpy(g, "cpu"), tst, tp, 0)
    for path, leaf in tree_flatten_with_path(tst["mat"]):
        want = torch.bfloat16 if path[-1] in ("L", "R", "QL", "QR") \
            else torch.float32
        assert leaf.dtype == want, path
    _assert_close(jd, td, "direction")
    _assert_close(jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                               jst["mat"]),
                  tree_map(lambda x: x.float(), tst["mat"]), "state")
