"""The port's Newton–Schulz composition and Muon against the JAX package:
``kernels/ns_ortho/ops.py`` against ``repro.kernels.ns_ortho.ref`` and
the Pallas ``newton_schulz_pallas`` in interpret mode; the CUDA kernel's
host tables (one launch a call, split above ``MAX_MATS``; tile coverage,
ticket order and scratch layout, and the whole schedule run in numpy
against the plain version); ``optim/muon.py`` over K steps against
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
import collections
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
from repro_torch.kernels.ns_ortho.ops import (
    NS_COEFFS, newton_schulz, newton_schulz_group, newton_schulz_group_plain,
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


# --------------------------------------- the CUDA kernel's host tables

def _spy(monkeypatch, module):
    """Records, per ``newton_schulz_group`` call made by ``module``, its
    matrix count and the kernel launches the card would make (the
    kernel's host tables on the matrices' wide dims)."""
    calls = []
    real = module.newton_schulz_group

    def spy(mats, **kw):
        dims = [(g.numel() // (g.shape[-2] * g.shape[-1]),
                 *sorted(g.shape[-2:])) for g in mats]
        calls.append((len(mats), len(ns_ops.launch_tables(dims, 5, 1e-7))))
        return real(mats, **kw)

    monkeypatch.setattr(module, "newton_schulz_group", spy)
    return calls


# the phases of a launch in ticket order, as ``enum`` in newton_schulz.cu:
# the norm's partial sums, the scaled copy, then A, B and X' of every step
RED, SCALE, PHASE_A, PHASE_B, PHASE_X = range(5)


def _need(kind: int, step: int, tm: int, tn: int) -> int:
    """Tiles of its own batch entry that a tile waits for: every tile of
    the phases before its own (``need`` in newton_schulz.cu)."""
    f, s = tm * tn, tm * (tm + 1) // 2
    first = 2 * f + step * (2 * s + f)
    return {RED: 0, SCALE: f, PHASE_A: first, PHASE_B: first + s,
            PHASE_X: first + 2 * s}[kind]


def _decode(table):
    """Every ticket of a launch table as the kernel decodes it (``decode``
    and ``need`` in newton_schulz.cu): a list of (kind, step, matrix record,
    batch entry, ti, tj, instance, need) in ticket order."""
    head = ns_ops.HEAD.itemsize
    h = table[:head].view(ns_ops.HEAD)[0]
    recs = table[head:].view(ns_ops.MAT)[:int(h["num_mats"])]
    f_total, s_total = int(h["full_total"]), int(h["sym_total"])
    full_starts, sym_starts = recs["full_start"], recs["sym_start"]
    out = []
    for t in range(int(h["total"])):
        step = 0
        if t < f_total:
            kind, local = RED, t
        elif t < 2 * f_total:
            kind, local = SCALE, t - f_total
        else:
            u = t - 2 * f_total
            step, local = divmod(u, 2 * s_total + f_total)
            kind = PHASE_A + min(local // s_total, 2)
            local -= (kind - PHASE_A) * s_total
        sym = kind in (PHASE_A, PHASE_B)
        starts = sym_starts if sym else full_starts
        mat = int(np.searchsorted(starts, local, side="right")) - 1
        r = recs[mat]
        tm, tn = int(r["tm"]), int(r["tn"])
        local -= int(starts[mat])
        b, idx = divmod(local, tm * (tm + 1) // 2 if sym else tm * tn)
        if sym:
            ti = 0
            while idx >= tm - ti:
                idx -= tm - ti
                ti += 1
            tj = ti + idx
        else:
            ti, tj = divmod(idx, tn)
        out.append((kind, step, mat, b, ti, tj, int(r["inst"]) + b,
                    _need(kind, step, tm, tn)))
    return out


def _tables(dims, steps=5, max_mats=ns_ops.MAX_MATS):
    dims = tuple(map(tuple, dims))
    return (ns_ops.arena_plan(dims, max_mats),
            ns_ops.launch_tables(dims, steps, 1e-7, max_mats=max_mats))


@pytest.mark.parametrize("n_mats", [48, 96, ns_ops.MAX_MATS,
                                    ns_ops.MAX_MATS + 3])
def test_one_launch_a_call_split_above_the_table(n_mats):
    """ceil(n / MAX_MATS) launches, each matrix in exactly one."""
    dims = [(2, 8, 16 if i % 2 else 8) for i in range(n_mats)]
    _, tables = _tables(dims)
    assert len(tables) == math.ceil(n_mats / ns_ops.MAX_MATS)
    assert sorted(i for _, idx in tables for i in idx) == list(range(n_mats))


# (batch, m, n) in wide form: a ViT-Tiny block at S=5 (192 = 3 tiles),
# ragged widths (the CNN stem's 8 x 27, 129 = 2 tiles + 1 row) and
# SmolLM-360M's two widths at small batch
SCHEDULES = {
    "vit_block": [(5, 192, 576), (5, 192, 192), (5, 192, 768),
                  (5, 192, 768)],
    "ragged": [(2, 8, 27), (3, 70, 130), (1, 129, 129), (2, 10, 24)],
    "smollm": [(2, 320, 960), (1, 960, 2560)],
}
SYMMETRIC = (PHASE_A, PHASE_B)


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_tiles_cover_each_phase_of_each_matrix_once(case):
    """The symmetric phases' tiles cover each upper triangle exactly once;
    the norm's, the scaled copy's and X''s tiles the whole matrix."""
    steps = 5
    dims = SCHEDULES[case]
    _, tables = _tables(dims, steps)
    for table, idx in tables:
        # instance k of the launch: (record, batch entry), in order
        insts = [(k, b) for k, i in enumerate(idx) for b in range(dims[i][0])]
        tiles = {}
        for kind, step, mat, b, ti, tj, inst, _ in _decode(table):
            assert insts[inst] == (mat, b)
            tiles.setdefault((kind, step, inst), []).append((ti, tj))
        for kind, step in [(RED, 0), (SCALE, 0)] + [
                (k, s) for s in range(steps) for k in
                (PHASE_A, PHASE_B, PHASE_X)]:
            for inst, (k, _) in enumerate(insts):
                _, m, n = dims[idx[k]]
                tm, tn = -(-m // ns_ops.TILE), -(-n // ns_ops.TILE)
                want = ([(a, c) for a in range(tm) for c in range(a, tm)]
                        if kind in SYMMETRIC else
                        [(a, c) for a in range(tm) for c in range(tn)])
                assert sorted(tiles[kind, step, inst]) == want, (kind, step)


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_every_dependency_is_ticketed_before_its_consumer(case):
    """A tile waits for its instance's count of finished tiles to reach
    its ``need``: exactly the tiles of the phases before its own, and all
    of those hold earlier tickets, so every wait ends."""
    def phase(kind, step):
        return kind if kind < PHASE_A else 2 + 3 * step + kind - 2

    _, tables = _tables(SCHEDULES[case])
    for table, _ in tables:
        seen = {}
        for t, (kind, step, _, _, _, _, inst, need) in enumerate(
                _decode(table)):
            p = phase(kind, step)
            earlier = seen.setdefault(inst, [])
            assert all(q <= p for q in earlier), "phases out of order"
            assert sum(q < p for q in earlier) == need, (t, kind, step)
            earlier.append(p)


def test_scratch_rows_are_aligned_and_regions_disjoint():
    dims = [(2, 8, 27), (3, 70, 130), (0, 5, 9), (1, 129, 129),
            (5, 192, 576), (2, 10, 24)] * 3
    plan = ns_ops.arena_plan(tuple(dims), max_mats=4)
    spans = [(c, c + 4 * (1 + sum(dims[i][0] for i in idx)))
             for c, idx in zip(plan["counters"], plan["groups"])]
    for i, (b, m, n) in enumerate(dims):
        if b == 0:
            assert all(i not in idx for idx in plan["groups"])
            continue
        ldx, lda = int(plan["ldx"][i]), int(plan["lda"][i])
        assert ldx % 4 == 0 and lda % 4 == 0 and ldx >= n and lda >= m
        start = int(plan["scratch"][i])
        assert start % ns_ops.ALIGN == 0
        # every row of X0 | X1 | A | B starts 16-byte aligned
        rows = np.concatenate([
            start + 4 * ldx * np.arange(2 * b * m),
            start + 4 * (2 * b * m * ldx + lda * np.arange(2 * b * m))])
        assert (rows % 16 == 0).all()
        spans.append((start, start + 4 * b * m * 2 * (ldx + lda)))
        part = 4 * int(plan["part"][i])
        tiles = -(-m // ns_ops.TILE) * -(-n // ns_ops.TILE)
        spans.append((part, part + 4 * b * tiles))
    spans.sort()
    assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan["nbytes"]


def _emulate(mats, steps, max_mats=ns_ops.MAX_MATS, eps=1e-7):
    """The kernel's schedule run ticket by ticket in numpy (f64): each
    tile as the kernel computes it, each symmetric tile stored twice, each
    wait checked against the tiles finished before it."""
    t, (a, b, c) = ns_ops.TILE, NS_COEFFS
    wide = [(g.swapaxes(-1, -2) if g.shape[-2] > g.shape[-1] else g)
            .reshape(-1, *sorted(g.shape[-2:])) for g in mats]
    plan, tables = _tables([w.shape for w in wide], steps, max_mats)
    outs = [np.full(w.shape, np.nan) for w in wide]
    for table, idx in tables:
        done, state = collections.Counter(), {}
        for kind, step, mat, bb, ti, tj, inst, need in _decode(table):
            assert done[inst] >= need
            i = idx[mat]
            w = wide[i][bb].astype(np.float64)
            m, n = w.shape
            st = state.setdefault(inst, dict(
                part={}, x=[np.full((m, n), np.nan) for _ in range(2)],
                a=np.full((m, m), np.nan), b=np.full((m, m), np.nan)))
            rows = slice(ti * t, ti * t + t)
            cols = slice(tj * t, tj * t + t)
            if kind == RED:
                st["part"][ti, tj] = (w[rows, cols] ** 2).sum()
            elif kind == SCALE:
                d = math.sqrt(sum(st["part"].values())) + eps
                dst = outs[i][bb] if steps == 0 else st["x"][0]
                dst[rows, cols] = w[rows, cols] / d
            elif kind in SYMMETRIC:
                lhs = st["x"][step % 2] if kind == PHASE_A else st["a"]
                v = lhs[rows] @ lhs[cols].T
                if kind == PHASE_B:
                    v = c * v + b * st["a"][rows, cols]
                dst = st["a"] if kind == PHASE_A else st["b"]
                dst[rows, cols], dst[cols, rows] = v, v.T
            else:
                x = st["x"][step % 2]
                dst = (outs[i][bb] if step == steps - 1
                       else st["x"][(step + 1) % 2])
                dst[rows, cols] = (st["b"][rows] @ x[:, cols]
                                   + a * x[rows, cols])
            done[inst] += 1
    return [(o.reshape(*g.shape[:-2], *sorted(g.shape[-2:])).swapaxes(-1, -2)
             if g.shape[-2] > g.shape[-1] else o.reshape(g.shape))
            for g, o in zip(mats, outs)]


@pytest.mark.parametrize("steps,max_mats", [(5, ns_ops.MAX_MATS), (5, 2),
                                            (2, ns_ops.MAX_MATS),
                                            (0, ns_ops.MAX_MATS)])
def test_schedule_run_in_numpy_matches_plain(steps, max_mats):
    """Wide, tall, square, 3-D and 4-D inputs, ragged at the tile edges
    (130, 70, 129): the kernel's schedule (its tiles, phases and waits)
    reproduces the plain version's output."""
    mats = [_rand(i, *s) for i, s in enumerate(
        [(12, 20), (3, 130, 70), (2, 129, 129), (18, 8), (2, 2, 10, 24)])]
    got = _emulate(mats, steps, max_mats)
    want = newton_schulz_group_plain([_t(x) for x in mats], steps=steps)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        _close(g, w.numpy())


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
    calls = _spy(monkeypatch, muon)
    p = params_from_numpy(_params(0, lead=(3,)), "cpu")
    opt = muon.make()
    opt.update(p, opt.init(p, lead=1), p, 0, lead=1)
    n_mats = sum(api.matrix_mask(p, lead=1)[k] for k in
                 ("w", "tall", "stem", "experts"))
    assert n_mats == 4
    assert calls == [(n_mats, 1)]


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
    calls = _spy(monkeypatch, soap)
    p = params_from_numpy(_params(0, lead=(2,)), "cpu")
    opt = soap.make(eig_method="ns", precond_freq=2)
    st = opt.init(p, lead=1)
    for k in range(3):                 # refreshes at steps 0 and 2
        _, st = opt.update(p, st, p, k, lead=1)
    sides = 8                          # 4 matrix leaves, L and R each
    assert calls == [(sides, 1)] * 2


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
