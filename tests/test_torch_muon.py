"""The port's Newton–Schulz composition and Muon against the JAX package:
``kernels/ns_ortho/ops.py`` against ``repro.kernels.ns_ortho.ref`` and
the Pallas ``newton_schulz_pallas`` in interpret mode; its grouping into
``matmul_fused_group`` calls; ``optim/muon.py`` over K steps against
``repro.optim.muon`` vmapped over the client axis; SOAP's
``eig_method="ns"`` refresh over K steps; and a 3-round ``fedpac_muon``
history on ``cifar_like_cnn``.

Tolerances:
  * Newton–Schulz (5 quintic steps in f32): 2e-5 absolute + 1e-4
    relative per element — the same products summed in other orders on
    the two sides, over 15 products; the outputs are O(1/sqrt(n)).
  * Muon directions and states over K steps: 2e-5 absolute + 1e-4
    relative, as tests/test_torch_soap.py holds SOAP.
  * SOAP with ``eig_method="ns"``: 1e-4 absolute + 1e-4 relative.  Its
    refreshed Q agrees to ~2e-6 (LAPACK's QR on both sides agrees to
    ~1e-7): the quintic map multiplies a roundoff in a small singular
    direction by up to a = 3.4445 a step, and the rotated Adam step
    after it divides by sqrt(v'), which amplifies again.
  * The 3-round history (as tests/test_torch_sophia.py holds Sophia):
    loss and test_loss 1e-4, drift and norm_drift 1e-3 relative,
    test_acc 2/768, upload bytes exact.  The port agrees to ~1e-6.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_experiment as jax_build
from repro.kernels.ns_ortho import ops as jax_ns_ops, ref as jax_ns_ref
from repro.optim import muon as jax_muon, soap as jax_soap
from repro_torch.api import build_experiment, materialize
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ns_ortho import ops as ns_ops
from repro_torch.kernels.ns_ortho.kernel import (
    MAX_PROBLEMS, group_tables, problem_row,
)
from repro_torch.kernels.ns_ortho.ops import (
    newton_schulz, newton_schulz_group, newton_schulz_group_plain,
)
from repro_torch.optim import api, muon, soap
from repro_torch.utils.tree import tree_flatten_with_path, tree_map

RTOL, ATOL = 1e-4, 2e-5
NS_SOAP_ATOL = 1e-4
K = 4
ROUNDS = 3
HIST_TOL = {"loss": 1e-4, "test_loss": 1e-4, "test_acc": 2 / 768}
HIST_REL_TOL = {"drift": 1e-3, "norm_drift": 1e-3}

SHAPES = {
    "w": (12, 20),                # wide matrix
    "tall": (20, 12),             # tall: orthogonalised as its transpose
    "stem": (3, 3, 2, 8),         # HWIO conv -> (18, 8), tall
    "experts": (2, 10, 12),       # batched matrices
    "head": {"w": (20, 5)},       # Adam fallback (name)
    "bias": (20,),                # Adam fallback (rank)
}


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, what="", atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=what)


# ----------------------------------------------------------- Newton–Schulz

NS_CASES = {
    "wide": (16, 40),
    "tall": (40, 16),
    "square": (24, 24),
    "3d": (3, 12, 20),
    "conv": (3, 3, 4, 16),        # HWIO: its (36, 16) matrix view, tall
}


def _ns_input(case):
    x = _rand(3, *NS_CASES[case])
    if case == "conv":
        x = x.reshape(-1, x.shape[-1])
    return x


NS_FNS = pytest.mark.parametrize(
    "fn", [newton_schulz_group, newton_schulz_group_plain],
    ids=["group", "plain"])


@NS_FNS
@pytest.mark.parametrize("case", list(NS_CASES))
def test_newton_schulz_matches_ref(fn, case):
    x = _ns_input(case)
    want = jax_ns_ops.newton_schulz(jnp.asarray(x))       # ref, 3-D vmapped
    got = fn([_t(x)])[0]
    assert tuple(got.shape) == x.shape and got.dtype == torch.float32
    _close(got, want, case)


@pytest.mark.parametrize("case", ["wide", "tall", "conv"])
def test_newton_schulz_plain_matches_pallas_interpret(case):
    x = _ns_input(case)
    want = jax_ns_ops.newton_schulz_pallas(jnp.asarray(x), interpret=True)
    _close(newton_schulz_group_plain([_t(x)])[0], want, case)
    _close(newton_schulz(_t(x)), want, case)


@NS_FNS
@pytest.mark.parametrize("shape", [(2, 12, 20), (2, 20, 12)],
                         ids=["wide", "tall"])
def test_prescale_is_per_client_not_per_stacked_leaf(fn, shape):
    """Two clients 100x apart in norm: each is orthogonalised as the
    reference does it for one client.  A norm over the whole (S, m, n)
    leaf would leave the small client far from orthogonal."""
    x = _rand(4, *shape)
    x[1] *= 100.0
    got = fn([_t(x)])[0].numpy()
    for i in range(2):
        _close(got[i], jax_ns_ref.newton_schulz(jnp.asarray(x[i])),
               f"client {i}")


def test_one_group_call_orthogonalises_every_matrix_as_alone():
    mats = [_t(_rand(i, *s)) for i, s in
            enumerate([(12, 20), (5, 20, 12), (3, 9, 9), (18, 8)])]
    together = newton_schulz_group(mats)
    for m, got in zip(mats, together):
        assert got.shape == m.shape
        torch.testing.assert_close(got, newton_schulz_group([m])[0],
                                   rtol=0, atol=0)


def _spy(monkeypatch):
    """Records, per ``matmul_fused_group`` call of the composition, its
    problem count and the number of kernel launches the card would make
    (``group_tables`` on the problems' records)."""
    calls = []
    real = ns_ops.matmul_fused_group

    def spy(problems):
        rows = [problem_row(*p, 0) for p in problems]
        calls.append((len(problems), len(group_tables(rows))))
        return real(problems)

    monkeypatch.setattr(ns_ops, "matmul_fused_group", spy)
    return calls


@pytest.mark.parametrize("n_mats,steps", [(48, 5), (96, 5), (MAX_PROBLEMS, 3),
                                          (MAX_PROBLEMS + 3, 5)])
def test_each_step_is_three_group_calls_split_above_the_table(
        monkeypatch, n_mats, steps):
    calls = _spy(monkeypatch)
    mats = [torch.randn(2, 8, 16 if i % 2 else 8) for i in range(n_mats)]
    newton_schulz_group(mats, steps=steps)
    per_call = math.ceil(n_mats / MAX_PROBLEMS)
    assert calls == [(n_mats, per_call)] * (3 * steps)


# ------------------------------------------------------------------- Muon

def _params(seed, lead=()):
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: r.standard_normal((*lead, *s)).astype(np.float32), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))


def _assert_trees_close(want_tree, got_tree, what, atol=ATOL):
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = tree_flatten_with_path(got_tree)
    assert len(want) == len(got), what
    for (wp, w), (gp, g) in zip(want, got):
        w = np.asarray(w, np.float32)
        g = g.detach().to(torch.float32).cpu().numpy()
        assert w.shape == g.shape, (what, gp)
        _close(g, w, f"{what} {gp}", atol=atol)


@pytest.mark.parametrize("kw", [{}, {"b1": 0.0}, {"weight_decay": 0.01}],
                         ids=["default", "b1=0", "weight_decay"])
def test_muon_k_steps_match_jax_vmapped(kw):
    """One stacked update over S=2 clients equals the reference vmapped
    over the client axis, step by step."""
    s = 2
    jopt, topt = jax_muon.make(**kw), muon.make(**kw)
    p = _params(0, lead=(s,))
    jst = jax.vmap(jopt.init)(p)
    tp = params_from_numpy(p, "cpu")
    tst = topt.init(tp, lead=1)
    jupd = jax.jit(jax.vmap(jopt.update, in_axes=(0, 0, 0, None)))
    r = np.random.default_rng(2)
    for k in range(K):
        g = jax.tree.map(lambda x: r.standard_normal(x.shape).astype(
            np.float32), p)
        jd, jst = jupd(g, jst, p, k)
        td, tst = topt.update(params_from_numpy(g, "cpu"), tst, tp, k,
                              lead=1)
        _assert_trees_close(jd, td, f"direction step {k}")
        _assert_trees_close(jst, tst, f"state step {k}")
    m = tst["m"]
    assert m["head"]["w"] is None and m["bias"] is None
    assert tst["am"]["w"] is None and tst["am"]["bias"] is not None


def test_muon_theta_round_trip_and_state_dtype():
    p = params_from_numpy(_params(0), "cpu")
    opt = muon.make(state_dtype=torch.bfloat16)
    st = opt.init(p)
    assert st["m"]["w"].dtype == torch.bfloat16
    theta = tree_map(lambda x: torch.ones_like(x), opt.get_precond(st))
    back = opt.get_precond(opt.set_precond(opt.init(p), theta))
    assert back["m"]["w"].dtype == torch.bfloat16
    assert bool((back["m"]["w"] == 1).all()) and back["m"]["bias"] is None
    d, st = opt.update(p, st, p, 0)
    assert st["m"]["w"].dtype == torch.bfloat16
    assert d["w"].dtype == torch.float32


def test_muon_step_is_one_group_call_over_every_matrix_leaf(monkeypatch):
    calls = _spy(monkeypatch)
    p = params_from_numpy(_params(0, lead=(3,)), "cpu")
    opt = muon.make()
    opt.update(p, opt.init(p, lead=1), p, 0, lead=1)
    n_mats = sum(api.matrix_mask(p, lead=1)[k] for k in
                 ("w", "tall", "stem", "experts"))
    assert n_mats == 4
    assert calls == [(n_mats, 1)] * 15


# ------------------------------------------------------ SOAP, NS refresh

def _spd(r, batch, n):
    a = r.standard_normal((*batch, n, n)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / n
            + 0.5 * np.eye(n, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("max_precond_dim", [8192, 15])
def test_soap_ns_refresh_k_steps_match_jax_from_spd_warm_start(
        max_precond_dim):
    kw = dict(precond_freq=2, max_precond_dim=max_precond_dim,
              eig_method="ns")
    jopt, topt = jax_soap.make(**kw), soap.make(**kw)
    p = _params(0)
    r = np.random.default_rng(1)
    theta = jax.tree.map(lambda x: _spd(r, x.shape[:-2], x.shape[-1]),
                         jopt.get_precond(jopt.init(p)))
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
        _assert_trees_close(jd, td, f"direction step {k}", NS_SOAP_ATOL)
        _assert_trees_close(jst, tst, f"state step {k}", NS_SOAP_ATOL)


def test_soap_ns_refresh_is_one_group_call(monkeypatch):
    calls = _spy(monkeypatch)
    p = params_from_numpy(_params(0, lead=(2,)), "cpu")
    opt = soap.make(eig_method="ns", precond_freq=2)
    st = opt.init(p, lead=1)
    for k in range(3):                 # refreshes at steps 0 and 2
        _, st = opt.update(p, st, p, k, lead=1)
    sides = 8                          # 4 matrix leaves, L and R each
    assert calls == [(sides, 1)] * 30


def test_soap_rejects_unknown_eig_method():
    with pytest.raises(ValueError, match="eig_method"):
        soap.make(eig_method="svd")


# ------------------------------------------------------------ whole slice

@pytest.fixture(scope="module")
def jax_muon_run():
    exp = jax_build("fedpac_muon", scenario="cifar_like_cnn", rounds=ROUNDS)
    return (exp.run(), exp.comm_bytes_per_round(),
            jax.tree.map(np.asarray, exp.scenario.params))


def test_fedpac_muon_history_matches_jax(jax_muon_run):
    want, want_bytes, jax_params = jax_muon_run
    scn = materialize("cifar_like_cnn", seed=0, n_clients=10, device="cpu")
    scn = dataclasses.replace(scn, params=params_from_numpy(jax_params, "cpu"))
    exp = build_experiment("fedpac_muon", scenario=scn, rounds=ROUNDS,
                           device="cpu")
    assert exp.lr == 3e-2
    got = exp.run()
    assert len(got) == len(want) == ROUNDS
    for r, (w, g) in enumerate(zip(want, got)):
        for k, tol in HIST_TOL.items():
            assert abs(w[k] - g[k]) <= tol, (r, k, w[k], g[k])
        for k, tol in HIST_REL_TOL.items():
            assert abs(w[k] - g[k]) <= tol * abs(w[k]), (r, k, w[k], g[k])
        for k in ("round", "upload_bytes", "upload_total_bytes",
                  "cohort_size", "beta", "freshness"):
            assert g[k] == w[k], k
    assert exp.comm_bytes_per_round() == want_bytes
