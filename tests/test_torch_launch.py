"""The port's launch layer (``repro_torch.launch.{steps,train}``, SOAP's
``state_dtype``, ``remat``, ``LocalRunConfig.beta``) against the JAX
package's.

The train step runs on the reduced ``smollm-360m`` and ``mixtral-8x22b``
tables in f32, from the reference's weights carried across, with Muon,
SOAP at ``state_dtype`` f32 and bf16 (eps 1e-3) and Sophia at ``step=1``
(its curvature gate off, so the two sides' probes cannot differ).  SOAP
warm-starts from a full-rank SPD L/R on both sides, so the step-0 QR
refresh is well posed (``tests/test_torch_soap.py`` says why a
rank-deficient one is not).  The fed round runs on the reduced LLaMA
with ``fedpac_soap`` on the dense and the qblock wire.  The reference
side is one small jitted program a case (eight compiles, ~26 s in all):
eagerly it took 63 s, and the cases joined into three programs took
longer to compile (~90 s) than the eight apart.

Tolerances:
  * loss: 2e-5 absolute (the LM logits' bound, tests/test_torch_lm.py).
  * params, directions and f32 states after a step: 2e-5 absolute +
    1e-4 relative (tests/test_torch_soap.py's).
  * SOAP at bf16 state: the stored L/R/Q 1/64 relative + 1e-3 absolute,
    params 1e-3 absolute: the two sides' f32 products differ in the last
    bits, which can move a bf16 rounding by one ulp (2^-8 relative) in L
    and then in the Q refreshed from it.  A direction element sums Q
    entries against unit-size Adam steps over up to m = 512 rows, so it
    may move by ~sqrt(m) 2^-8 ~ 0.09, doubled for Q_L and Q_R; times
    lr (1 - beta) = 5e-3 that is 1e-3 on a param.
  * fed round, dense: the train step's tolerances over K=2 steps and the
    aggregation: 5e-5 absolute + 1e-4 relative.  qblock: a delta element
    may land one int8 level apart (the block's scale, amax/127) where the
    two sides' f32 deltas straddle a rounding boundary; params and g_G
    within one level of the largest block (2e-4 here).
  * remat: 1e-6 relative on loss and params (the same arithmetic
    recomputed).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro import configs as jax_configs
from repro import optim as jax_optim
from repro.core import transport as JT
from repro.core.client import LocalRunConfig as JaxRunConfig
from repro.launch import steps as jax_steps
from repro.models import model as jax_model
from repro_torch import configs, optim
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.convert import params_from_numpy
from repro_torch.core import transport as T
from repro_torch.core.client import LocalRunConfig
from repro_torch.launch import steps, train
from repro_torch.obs import validate_jsonl
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_leaves,
)

RTOL, ATOL = 1e-4, 2e-5
LOSS_TOL = 2e-5
B, S = 4, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch CPU thread and one OpenBLAS thread for the module (both
    restored after).  After a jitted reference program, torch's OpenMP
    pool ran the port's steps 5x slower here; and on a loaded machine (the
    other test workers) a jitted QR, which jaxlib sends to OpenBLAS, ran
    200x slower with OpenBLAS's default threads.  A first QR loads that
    library, so that the limit reaches it.  The models are small enough
    for one thread."""
    jnp.linalg.qr(jnp.eye(2))[0].block_until_ready()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (jax_configs.get_reduced(arch).replace(dtype="float32"),
            configs.get_reduced(arch).replace(dtype="float32"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(tree, "cpu")


def _inputs(arch, seed=0):
    jcfg, cfg = _cfgs(arch)
    p = _np(jax_model.init_params(jcfg, jax.random.key(seed)))
    r = np.random.default_rng(seed + 1)
    tok = r.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    gg = jax.tree.map(lambda x: (0.01 * r.standard_normal(x.shape)).astype(
        np.float32), p)
    return jcfg, cfg, p, batch, gg


def _spd(r, batch, n):
    a = r.standard_normal((*batch, n, n)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / n
            + 0.5 * np.eye(n, dtype=np.float32)).astype(np.float32)


def _spd_theta(jopt, params, seed):
    r = np.random.default_rng(seed)
    shapes = jopt.get_precond(jopt.init(params))
    return jax.tree.map(lambda x: _spd(r, x.shape[:-2], x.shape[-1]), shapes)


def _assert_close(want_tree, got_tree, what, rtol=RTOL, atol=ATOL):
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = tree_flatten_with_path(got_tree)
    assert len(want) == len(got), what
    for (_, w), (gp, g) in zip(want, got):
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        g = g.detach().to(torch.float32).numpy()
        assert w.shape == g.shape, (what, gp)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {gp}")


# ------------------------------------------------------------ train step

CASES = {
    "muon": (dict(), 0),
    "soap_f32": (dict(eps=1e-3), 0),
    "soap_bf16": (dict(eps=1e-3, state_dtype="bfloat16"), 0),
    "sophia": (dict(), 1),
}


def _opts(case):
    kw, step = CASES[case]
    name = case.split("_")[0]
    jkw = dict(kw)
    if "state_dtype" in jkw:
        jkw["state_dtype"] = getattr(jnp, jkw["state_dtype"])
    return jax_optim.make(name, **jkw), optim.make(name, **kw), step


def _states(case, jopt, topt, p):
    jst, tst = jopt.init(p), topt.init(_t(p))
    if case.startswith("soap"):
        theta = _spd_theta(jopt, p, 7)
        if case == "soap_bf16":
            theta = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                 theta)
        jst = jopt.set_precond(jst, theta)
        tst = topt.set_precond(tst, _t(jax.tree.map(
            lambda x: np.asarray(x, np.float32), theta)))
    return jst, tst


TRAIN_CASES = {"smollm-360m": ("muon", "soap_f32", "soap_bf16", "sophia"),
               "mixtral-8x22b": ("soap_bf16", "sophia")}
LR = 1e-2


@functools.lru_cache(maxsize=None)
def _arch_inputs(arch):
    return _inputs(arch)


def _reference_train_step(arch, case):
    """The reference's train step, jitted: (params, state, loss), and the
    inputs."""
    jcfg, cfg, p, batch, gg = _arch_inputs(arch)
    jopt, topt, step = _opts(case)
    jst, tst = _states(case, jopt, topt, p)
    fn = jax.jit(jax_steps.make_train_step(jcfg, jopt, lr=LR),
                 static_argnums=4)
    return fn(p, jst, gg, batch, step), (cfg, p, batch, gg, topt, tst, step)


@pytest.mark.parametrize("arch,case", [
    (a, c) for a, cases in TRAIN_CASES.items() for c in cases])
def test_train_step_matches_reference(arch, case):
    (jp, jst, jloss), (cfg, p, batch, gg, topt, tst, step) = \
        _reference_train_step(arch, case)
    tfn = steps.make_train_step(cfg, topt, lr=LR)
    tp, tst, tloss = tfn(_t(p), tst, _t(gg), _t(batch), step)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    if case == "soap_bf16":
        _assert_close(jp, tp, "params", rtol=0, atol=1e-3)
        for path, leaf in tree_flatten_with_path(tst["mat"]):
            if path[-1] in ("L", "R", "QL", "QR"):
                assert leaf.dtype == torch.bfloat16, path
            else:
                assert leaf.dtype == torch.float32, path
        _assert_close(jst["mat"], tst["mat"], "state", rtol=1 / 64,
                      atol=1e-3)
        return
    _assert_close(jp, tp, "params")
    _assert_close(jst, tst, "state")


def test_sophia_refresh_step_runs_and_moves_params():
    _, cfg, p, batch, gg = _inputs("smollm-360m")
    opt = optim.make("sophia")
    fn = steps.make_train_step(cfg, opt, lr=1e-2)
    tp, st, loss = fn(_t(p), opt.init(_t(p)), _t(gg), _t(batch), 0)
    assert torch.isfinite(loss)
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(tp), tree_leaves(_t(p))))
    assert all(torch.all(h >= 0) for h in tree_leaves(st["h"]))
    assert any(torch.any(h > 0) for h in tree_leaves(st["h"]))


@pytest.mark.parametrize("case", ["soap_f32", "sophia_refresh"])
def test_remat_equals_no_remat(case):
    """remat recomputes each layer (twice more for Sophia's double
    backward): the same loss and params."""
    _, cfg, p, batch, gg = _inputs("smollm-360m")
    opt = optim.make(case.split("_")[0])
    out = []
    for remat in (False, True):
        fn = steps.make_train_step(cfg, opt, lr=1e-2, remat=remat)
        out.append(fn(_t(p), opt.init(_t(p)), _t(gg), _t(batch), 0))
    (p0, _, l0), (p1, _, l1) = out
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ fed round

def _fed_inputs():
    jcfg, cfg, p, _, gg = _inputs("llama-60m")
    r = np.random.default_rng(3)
    clients, k, micro = 4, 2, 2
    tok = r.integers(0, cfg.vocab_size,
                     (clients * k * micro, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    return jcfg, cfg, p, batch, gg, clients, k


WIRES = ("dense", "qblock")
FED_KW = dict(lr=LR, beta=0.5, algorithm="fedpac_soap")


def _transport(mod, wire, **cfg):
    if wire == "dense":
        return None
    return mod.Transport(
        mod.resolve_codec("qblock", mod.TransportConfig(**cfg)),
        mod.Dense(), error_feedback=False)


def _reference_fed_round(wire):
    """The reference's round on ``wire``, jitted (its qblock through the
    plain ``ref.py`` path, not Pallas interpret)."""
    jcfg, cfg, p, batch, gg, clients, k = _fed_inputs()
    jopt = jax_optim.make("soap", eps=1e-3)
    theta = _spd_theta(jopt, p, 11)
    fn = jax_steps.make_fed_round_step(
        jcfg, jopt, remat=False, clients=clients, local_steps=k,
        transport=_transport(JT, wire, use_pallas=False), **FED_KW)
    out = jax.jit(fn)(p, theta, gg, batch, jax.random.key(0))
    return out, (cfg, p, theta, batch, gg, clients, k)


@pytest.mark.parametrize("wire", WIRES)
def test_fed_round_matches_reference(wire):
    (jp, jth, jg, jloss), (cfg, p, theta, batch, gg, clients, k) = \
        _reference_fed_round(wire)
    tfn = steps.make_fed_round_step(
        cfg, optim.make("soap", eps=1e-3), clients=clients, local_steps=k,
        transport=_transport(T, wire), **FED_KW)
    tp, tth, tg, tloss = tfn(_t(p), _t(theta), _t(gg), _t(batch))
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    atol = 5e-5 if wire == "dense" else 2e-4
    _assert_close(jp, tp, "params", atol=atol)
    _assert_close(jg, tg, "g_global", atol=atol / LR)
    _assert_close(jth, tth, "theta", atol=atol)


def test_fed_round_keeps_the_reference_errors():
    jcfg, cfg, *_ = _fed_inputs()
    for mod, c, o, tr in (
            (jax_steps, jcfg, jax_optim.make("soap"),
             JT.Transport(JT.resolve_codec("qblock"), JT.Dense())),
            (steps, cfg, optim.make("soap"),
             T.Transport(T.resolve_codec("qblock"), T.Dense()))):
        extra = {"remat": False}
        with pytest.raises(ValueError, match="beta='auto'"):
            mod.make_fed_round_step(c, o, lr=1e-2, beta="auto",
                                    algorithm="fedpac_soap", **extra)
        with pytest.raises(ValueError, match="error feedback"):
            mod.make_fed_round_step(c, o, lr=1e-2, transport=tr, **extra)
    # the cohort runs under torch.func: remat is a stated limit there
    with pytest.raises(NotImplementedError, match="torch.func"):
        steps.make_fed_round_step(cfg, optim.make("soap"), lr=1e-2,
                                  remat=True)


def test_local_run_config_beta_matches_reference():
    assert LocalRunConfig(lr=0.1, local_steps=2).beta == \
        JaxRunConfig(lr=0.1, local_steps=2).beta == 0.0
    assert LocalRunConfig(0.1, 2, 0.3).beta == JaxRunConfig(0.1, 2, 0.3).beta


# ------------------------------------------------------------ train.main

def test_train_main_runs_traces_checkpoints_and_resumes(tmp_path):
    out, trace, ck = (str(tmp_path / n) for n in ("h.json", "t.jsonl", "ck"))
    argv = ["--reduced", "--device", "cpu", "--rounds", "2", "--clients",
            "4", "--local-steps", "2", "--batch", "2", "--seq", "16",
            "--out", out, "--trace", trace, "--checkpoint-dir", ck,
            "--checkpoint-every", "1"]
    hist = []
    assert train.main(argv, history=hist) == 0
    assert [r["round"] for r in hist] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["eval_loss"])
               for r in hist)
    assert json.load(open(out)) == json.loads(json.dumps(hist))
    n_events = validate_jsonl(trace)
    assert latest_step(ck) == 2
    meta = CheckpointManager(ck).restore_meta()
    run_id = meta["telemetry"]["run_id"]
    # a second run appends to the same trace under the same run id
    assert train.main(argv) == 0
    assert validate_jsonl(trace) > n_events
    with open(trace) as f:
        assert {json.loads(line)["run_id"] for line in f} == {run_id}
