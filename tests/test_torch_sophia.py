"""The port's Sophia slice against the JAX package: the ``sophia_update``
kernel's plain version, ``optim/sophia.py`` over K steps, Sophia's
Hutchinson curvature (``core.client.hutchinson_estimate``), and 3-round
histories of ``local_sophia``, ``fedpac_sophia`` and ``fedpac_sophia``
with the qblock codec on both channels and error feedback, on
``cifar_like_cnn``.

The reference draws its Rademacher probes from ``jax.random``; the port
from a ``torch.Generator``.  Parity runs therefore rebuild the reference's
probes in its split order — round key -> S clients -> K steps -> leaves —
and inject them through the port's ``probe_fn`` seam.

Tolerances:
  * ``sophia_update``: 1e-6 max(1, |x|) — the same f32 expression; the
    inputs include h = 0 and clip-saturated entries.
  * optimizer over K steps: 1e-6 absolute + 1e-5 relative on directions
    and states, from the same gradients and estimates.
  * Hutchinson: 1e-4 relative per element plus 1e-5 of the leaf's
    largest |u*Hu| — the models' gradient tolerance
    (tests/test_torch_models.py), with the absolute part scaled to the
    leaf: an HVP entry is a sum of second-derivative products whose
    roundoff follows the leaf's scale (ViT-block entries reach ~10, and
    one of 9216 entries of a w2 differs by 1.4e-5).
  * whole rounds (lr 2e-2, the repo's vision Sophia lr): loss and
    test_loss 1e-4 absolute, drift and norm_drift 1e-3 relative,
    test_acc 2/768 (two eval images); upload bytes exactly equal.  Sophia
    amplifies roundoff only where m' is within roundoff of 0 and h is
    below |m'|/rho (the clip then takes the sign of roundoff); at these
    sizes the histories agree to ~1e-5, two orders inside the tolerance,
    and the tolerance still tells ``local_sophia`` from ``fedpac_sophia``
    (asserted below).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_experiment as jax_build
from repro.core.client import hutchinson_estimate as jax_hutchinson
from repro.kernels.sophia_update import ref as jax_sophia_ref
from repro.kernels.sophia_update.kernel import (
    sophia_update as jax_sophia_pallas,
)
from repro.optim import sophia as jax_sophia
from repro.scenarios import materialize as jax_materialize
from repro_torch.api import build_experiment, materialize
from repro_torch.convert import params_from_numpy
from repro_torch.core.algorithms import build_round_fn, zero_theta
from repro_torch.core.client import (
    LocalRunConfig, hutchinson_estimate, rademacher_like,
)
from repro_torch.kernels.sophia_update.kernel import (
    sophia_update, sophia_update_plain,
)
from repro_torch.optim import sophia
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_leaves, tree_map_with_path,
)

ROUNDS = 3
LR = 2e-2
TOL = {"loss": 1e-4, "test_loss": 1e-4, "test_acc": 2 / 768}
REL_TOL = {"drift": 1e-3, "norm_drift": 1e-3}
QBLOCK = dict(delta_codec="qblock", theta_codec="qblock")
RUNS = {"local_sophia": ("local_sophia", {}),
        "fedpac_sophia": ("fedpac_sophia", {}),
        "fedpac_sophia_qblock_ef": ("fedpac_sophia", QBLOCK)}


def _assert_close(want_tree, got_tree, what, rtol=1e-5, atol=1e-6,
                  leaf_scaled=False):
    """Elementwise ``atol + rtol |want|``; with ``leaf_scaled`` the atol
    is relative to the leaf's largest |want|."""
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = tree_flatten_with_path(got_tree)
    assert len(want) == len(got), what
    for (_, w), (gp, g) in zip(want, got):
        w = np.asarray(w)
        g = g.detach().cpu().numpy()
        assert w.shape == g.shape, (what, gp)
        scale = max(1.0, float(np.abs(w).max())) if leaf_scaled else 1.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * scale,
                                   err_msg=f"{what} {gp}")


# ---------------------------------------------------------- sophia_update

def _sophia_inputs(shape, seed):
    r = np.random.default_rng(seed)
    g = r.standard_normal(shape).astype(np.float32)
    m = r.standard_normal(shape).astype(np.float32)
    h = np.abs(r.standard_normal(shape)).astype(np.float32) * 50.0
    flat = h.reshape(-1)
    flat[::3] = 0.0                  # h = 0: the clip saturates
    flat[1::7] = 1e-3                # small h: |m'/h| far above rho
    return g, m, h


@pytest.mark.parametrize("shape", [(7,), (5, 192, 24), (3, 3, 8, 16)])
def test_sophia_update_plain_matches_ref_and_pallas(shape):
    g, m, h = _sophia_inputs(shape, len(shape))
    kw = dict(b1=0.9, rho=0.05, eps=1e-12)
    got_d, got_m = sophia_update(*map(torch.from_numpy, (g, m, h)), **kw)
    want_ref = jax_sophia_ref.sophia_update(g, m, h, **kw)
    want_pal = jax_sophia_pallas(jnp.asarray(g), jnp.asarray(m),
                                 jnp.asarray(h), interpret=True, **kw)
    for want in (want_ref, want_pal):
        for got, w in zip((got_d, got_m), want):
            w = np.asarray(w)
            assert got.shape == w.shape and got.dtype == torch.float32
            assert np.all(np.abs(got.numpy() - w)
                          <= 1e-6 * np.maximum(1.0, np.abs(w)))
    d = got_d.numpy().reshape(-1)
    assert np.all(np.abs(d[::3]) == 0.05)        # saturated where h = 0
    assert np.all(np.abs(d) <= 0.05)


def test_sophia_update_wrapper_dispatch():
    x = torch.ones(4)
    assert sophia_update_plain is not sophia_update
    with pytest.raises(ValueError, match="shape"):
        sophia_update(x, x, torch.ones(5))
    with pytest.raises(ValueError, match="unsupported device"):
        meta = torch.ones(4, device="meta")
        sophia_update(meta, meta, meta)
    before = sophia_update.launches
    sophia_update(x, x, x)
    assert sophia_update.launches == before   # the CPU runs the plain path


# --------------------------------------------------------------- optimizer

SHAPES = {"w": (12, 20), "stem": (3, 3, 2, 8), "head": {"b": (5,)}}


def _tree(r, lead=()):
    return jax.tree.map(
        lambda s: r.standard_normal((*lead, *s)).astype(np.float32), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("kw", [{}, dict(weight_decay=0.01, b1=0.8,
                                         rho=0.1)])
def test_sophia_k_steps_match_jax_stacked(kw):
    """K updates of the stacked (S, ...) state equal the reference run
    client by client (vmapped), from an aligned theta, with the
    Hutchinson estimate injected on gated steps only (hessian_freq 2)."""
    s, k_steps, freq = 3, 5, 2
    r = np.random.default_rng(0)
    params = _tree(r, (s,))
    theta = jax.tree.map(np.abs, _tree(r))
    jopt, topt = jax_sophia.make(**kw), sophia.make(**kw)
    jst = jax.vmap(lambda p: jopt.set_precond(jopt.init(p), {"h": theta}))(
        params)
    tp = params_from_numpy(params, "cpu")
    tst = topt.set_precond(topt.init(tp, lead=1),
                           params_from_numpy({"h": theta}, "cpu"))
    assert topt.needs_hessian and jopt.needs_hessian
    jupd = jax.jit(jax.vmap(
        lambda g, st, p, est, gate: jopt.update(
            g, st, p, 0, {"h_est": est, "h_gate": gate}),
        in_axes=(0, 0, 0, 0, None)))
    for k in range(k_steps):
        g = _tree(r, (s,))
        est = _tree(r, (s,))
        gate = k % freq == 0
        jd, jst = jupd(g, jst, params, est, gate)
        extras = {"h_est": params_from_numpy(est, "cpu")} if gate else None
        td, tst = topt.update(params_from_numpy(g, "cpu"), tst, tp, k,
                              lead=1, extras=extras)
        _assert_close(jd, td, f"direction step {k}")
        _assert_close(jst, tst, f"state step {k}")
    _assert_close({"h": jst["h"]}, topt.get_precond(tst), "theta")


def test_sophia_zero_theta_matches_jax():
    r = np.random.default_rng(1)
    p = _tree(r)
    want = jax.eval_shape(jax_sophia.make().init, p)["h"]
    got = zero_theta(sophia.make(), params_from_numpy(p, "cpu"))
    assert set(got) == {"h"}
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got["h"])):
        assert tuple(g.shape) == w.shape and not bool(g.any())


# -------------------------------------------------------------- hutchinson

@functools.partial(jax.jit, static_argnums=1)
def _reference_probes_one(key, shapes):
    """One client's probes at one step, as ``repro.core.client.
    hutchinson_estimate`` draws them from its step key."""
    keys = jax.random.split(key, len(shapes))
    return [jax.random.rademacher(k, s).astype(jnp.float32)
            for k, s in zip(keys, shapes)]


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _reference_probes(seed, s, k_steps, k, shapes):
    """Stacked (S, ...) probes of step ``k`` of a round whose key is
    ``jax.random.key(seed)``: round key -> S clients -> K steps ->
    leaves."""
    clients = jax.random.split(jax.random.key(seed), s)
    steps = jax.vmap(lambda c: jax.random.split(c, k_steps)[k])(clients)
    return jax.vmap(lambda key: _reference_probes_one(key, shapes))(steps)


def _as_port_tree(leaves, like):
    by_path = {path: torch.from_numpy(np.array(x)).to(leaf.device)
               for (path, leaf), x in zip(tree_flatten_with_path(like),
                                          leaves)}
    return tree_map_with_path(lambda path, _: by_path[path], like)


@pytest.mark.parametrize("name", ["cifar_like_cnn", "cifar_like_vit"])
def test_hutchinson_matches_jax_with_reference_probes(name):
    """u * (H u) on the CNN and the 2-layer ViT, from the reference's own
    probes (rebuilt from the same key), against ``jax.jvp`` of
    ``jax.grad``."""
    jscn = jax_materialize(name, seed=0, n_clients=4)
    jparams, jloss, jbatch_fn, _ = jscn.problem()
    batch = {k: np.asarray(v)
             for k, v in jbatch_fn(1, np.random.default_rng(0)).items()}
    key = jax.random.key(7)
    want = jax.jit(lambda p, b: jax_hutchinson(jloss, p, b, key))(
        jparams, batch)
    tscn = materialize(name, seed=0, n_clients=4, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    shapes = tuple(tuple(x.shape) for x in jax.tree.leaves(jparams))
    probes = _as_port_tree(_reference_probes_one(key, shapes), tparams)
    got = hutchinson_estimate(
        tscn.loss_fn, tparams, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, probes)
    _assert_close(want, got, "u*Hu", rtol=1e-4, atol=1e-5, leaf_scaled=True)


def test_hutchinson_probes_and_gate():
    gen = torch.Generator().manual_seed(3)
    like = {"a": torch.zeros(2, 3), "b": [torch.zeros(4)]}
    u = rademacher_like(like, gen)
    for x in tree_leaves(u):
        assert x.dtype == torch.float32 and set(x.unique().tolist()) <= {
            -1.0, 1.0}
    again = rademacher_like(like, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(u),
                                                 tree_leaves(again)))
    with pytest.raises(ValueError, match="hessian_freq"):
        LocalRunConfig(lr=0.1, local_steps=2, hessian_freq=0)


# ------------------------------------------------------------ whole slice

@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for key, (algo, kw) in RUNS.items():
        exp = jax_build(algo, scenario="cifar_like_cnn", rounds=ROUNDS,
                        lr=LR, **kw)
        out[key] = (exp.run(), exp.comm_bytes_per_round(),
                    jax.tree.map(np.asarray, exp.scenario.params))
    return out


def _port_run(algo, kw, jax_params):
    scn = materialize("cifar_like_cnn", seed=0, n_clients=10, device="cpu")
    scn = dataclasses.replace(scn, params=params_from_numpy(jax_params, "cpu"))
    exp = build_experiment(algo, scenario=scn, rounds=ROUNDS, device="cpu",
                           lr=LR, **kw)
    s = max(1, int(round(exp.fed.n_clients * exp.fed.participation)))
    shapes = tuple(tuple(x.shape) for x in tree_leaves(exp.server.params))

    def probe_fn(seed, k):
        leaves = _reference_probes(seed, s, exp.fed.local_steps, k, shapes)
        return _as_port_tree(leaves, exp.server.params)

    exp.round_fn = build_round_fn(
        exp.spec, exp.loss_fn, exp.opt, lr=exp.lr,
        local_steps=exp.fed.local_steps,
        beta=exp.spec.resolve_beta(exp.fed.beta),
        hessian_freq=exp.fed.hessian_freq, transport=exp.transport,
        n_clients=exp.fed.n_clients, probe_fn=probe_fn)
    return exp.run(), exp.comm_bytes_per_round(), exp


def _mismatches(want_hist, got_hist):
    bad = []
    for r, (w, g) in enumerate(zip(want_hist, got_hist)):
        for k, tol in TOL.items():
            if abs(w[k] - g[k]) > tol:
                bad.append((r, k, w[k], g[k]))
        for k, tol in REL_TOL.items():
            if abs(w[k] - g[k]) > tol * abs(w[k]):
                bad.append((r, k, w[k], g[k]))
    return bad


@pytest.mark.parametrize("run", list(RUNS))
def test_sophia_slice_history_matches_jax(jax_runs, run):
    algo, kw = RUNS[run]
    want, want_bytes, jax_params = jax_runs[run]
    got, got_bytes, exp = _port_run(algo, kw, jax_params)
    assert len(got) == len(want) == ROUNDS
    assert _mismatches(want, got) == []
    for w, g in zip(want, got):
        assert g["round"] == w["round"]
        for k in ("upload_bytes", "upload_total_bytes", "cohort_size",
                  "beta", "freshness"):
            assert g[k] == w[k], k
    assert got_bytes == want_bytes
    if kw:
        # int8 + f32 scales on both channels, EF residuals as client state
        assert got_bytes < 0.3 * 2 * 4 * sum(
            x.numel() for x in tree_leaves(exp.server.params))
        assert exp.transport.feedback_active
        assert tuple(exp.client_state["stem"].shape) == (
            10, *exp.server.params["stem"].shape)
    else:
        assert exp.client_state is None
    # the tolerance tells the two algorithms apart
    other = "local_sophia" if run != "local_sophia" else "fedpac_sophia"
    assert _mismatches(jax_runs[other][0], got) != []


def test_sophia_slice_trains_with_generator_probes():
    """Not parity: the port's own probes (a torch.Generator seeded from
    the round's draw).  Finite histories, the global test loss below the
    initial model's, and a rerun from the same seed is identical."""
    hists = []
    for _ in range(2):
        exp = build_experiment("fedpac_sophia", scenario="cifar_like_cnn",
                               rounds=ROUNDS, participation=0.5, lr=LR,
                               device="cpu", **QBLOCK)
        init = float(exp.eval_fn(exp.server.params)["test_loss"])
        hists.append(exp.run())
    assert all(np.isfinite(r[k]) for r in hists[0]
               for k in ("loss", "test_loss", "drift", "norm_drift"))
    assert hists[0][-1]["test_loss"] < init
    assert hists[0] == hists[1]
