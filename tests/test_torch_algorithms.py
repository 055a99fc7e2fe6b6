"""The port's algorithm layer against the JAX package: SCAFFOLD's local
update and state protocol, FedPM's mixing weights, 3-round histories on
``cifar_like_cnn`` for ``scaffold`` (dense, and on the qblock delta wire
with error feedback: the composed state), ``fedpm_adamw``,
``fedpac_adamw_light`` and ``fedpac_soap_light``, the legacy entry points
(``make_round_fn``, the FedSOA ``VARIANTS``, the compression shims), the
``*_light`` registry, ``FedConfig``'s codec knobs, and the controllers'
required device.

Tolerances:
  * SCAFFOLD over K steps: 1e-6 absolute + 1e-5 relative (the same f32
    SGD algebra; gradients from CPU convolutions in another order).
  * mixing weights: 1e-6 relative.
  * histories, upload bytes exact everywhere:
      - scaffold (dense and qblock+EF), fedpm_adamw, fedpac_adamw_light:
        loss and test_loss 1e-4, test_acc 2/768, drift and norm_drift
        1e-4 relative (as tests/test_torch_baselines.py holds SGD); the
        port agrees to ~2e-6.  ``fedpac_adamw_light`` turns NaN from round
        2 on both sides: the rank-4 reconstruction of AdamW's second
        moment has negative entries, and the next round's sqrt is NaN
        (ROADMAP §3); NaN must meet NaN.
      - fedpac_soap_light at eps=1e-3: SOAP's whole-round tolerances of
        tests/test_torch_round.py (loss 5e-3, test_loss 2e-2, test_acc
        6/768, drift and norm_drift 5% relative), not wider; the port
        agrees to ~4e-3 in test_loss and 1.3% in drift.
  * make_round_fn and the FedSOA variants, 2 rounds of SGD with momentum
    (its Theta, the momentum, goes through the legacy SVD round-trip):
    the server params within 1e-5 absolute + 1e-4 relative.
  * compression shims: bytes exact; the stacked SVD round-trip within
    1e-5 of the matrices' magnitude (gapped spectra).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.api import build_experiment as jax_build
from repro.core import compression as jax_compression
from repro.core import fedsoa as jax_fedsoa
from repro.core import init_server as jax_init_server
from repro.core.algorithms import (
    registered as jax_registered, resolve as jax_resolve,
)
from repro.core.engine.aggregation import (
    precond_mixing_weights as jax_mixing,
)
from repro.core.scaffold import (
    make_scaffold_local_update as jax_scaffold_update,
)
from repro.core.client import LocalRunConfig as JaxRunConfig
from repro.scenarios import materialize as jax_materialize
from repro_torch import optim
from repro_torch.api import (
    AlgorithmSpec, ClientStateSpec, build_experiment, materialize,
    registered, resolve,
)
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression, fedsoa, init_server
from repro_torch.core import transport as T
from repro_torch.core.algorithms import (
    make_local_update, round_client_state_spec, state_export, state_import,
    state_import_many,
)
from repro_torch.core.client import LocalRunConfig
from repro_torch.core.engine import (
    auto_controller, fixed_controller, make_cohort_executor, make_controller,
    precond_mixing_weights,
)
from repro_torch.core.scaffold import ScaffoldState
from repro_torch.fed.rounds import FedConfig
from repro_torch.fed.scaffold import SCAFFOLD_SPEC
from repro_torch.scenarios import Scenario
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_leaves, tree_map,
)

ROUNDS = 3
FIRST_TOL = {"loss": 1e-4, "test_loss": 1e-4, "test_acc": 2 / 768}
FIRST_REL = {"drift": 1e-4, "norm_drift": 1e-4}
SOAP_TOL = {"loss": 5e-3, "test_loss": 2e-2, "test_acc": 6 / 768}
SOAP_REL = {"drift": 0.05, "norm_drift": 0.05}
RUNS = {
    "scaffold": ("scaffold", {}, FIRST_TOL, FIRST_REL),
    "scaffold_qblock_ef": ("scaffold", dict(delta_codec="qblock",
                                            error_feedback=True),
                           FIRST_TOL, FIRST_REL),
    "fedpm_adamw": ("fedpm_adamw", {}, FIRST_TOL, FIRST_REL),
    "fedpac_adamw_light": ("fedpac_adamw_light", dict(svd_rank=4),
                           FIRST_TOL, FIRST_REL),
    "fedpac_soap_light": ("fedpac_soap_light",
                          dict(svd_rank=4, opt_kwargs={"eps": 1e-3}),
                          SOAP_TOL, SOAP_REL),
}


def _assert_trees_close(want_tree, got_tree, what, rtol, atol):
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = tree_flatten_with_path(got_tree)
    assert len(want) == len(got), what
    for (wp, w), (gp, g) in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {gp}")


# ---------------------------------------------------------------- SCAFFOLD

def _linear_problem(seed, s=3, k=4, b=5):
    r = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    params = {"w": f(6, 4), "b": f(4)}
    batches = {"x": f(s, k, b, 6), "y": f(s, k, b, 4)}
    c_global = {"w": f(6, 4, scale=0.1), "b": f(4, scale=0.1)}
    c_i = {"w": f(s, 6, 4, scale=0.1), "b": f(s, 4, scale=0.1)}
    return params, batches, c_global, c_i


def _jax_loss(p, batch):
    return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)


def _torch_loss(p, batch):
    return torch.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)


def test_scaffold_local_update_matches_jax_vmapped():
    params, batches, c_global, c_i = _linear_problem(0)
    jfn = jax_scaffold_update(None, _jax_loss, None,
                              JaxRunConfig(lr=0.05, local_steps=4))

    def one(ci, batch_i):
        return jfn(params, None, None, beta=0.0, view=(c_global, ci),
                   batch_i=batch_i, key_i=None)

    jd, _, (jc, jdc), jl = jax.vmap(one)(c_i, batches)
    tfn = make_local_update(SCAFFOLD_SPEC, _torch_loss, None,
                            LocalRunConfig(lr=0.05, local_steps=4))
    t = lambda tree: params_from_numpy(tree, "cpu")  # noqa: E731
    td, ttheta, (tc, tdc), tl = tfn(
        t(params), None, None, beta=0.0, view=(t(c_global), t(c_i)),
        batches=t(batches), cohort_exec=make_cohort_executor())
    assert ttheta is None
    for what, want, got in (("delta", jd, td), ("c_i'", jc, tc),
                            ("c_i' - c_i", jdc, tdc)):
        _assert_trees_close(want, got, what, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tl), float(jnp.mean(jl)), rtol=1e-5)


def test_scaffold_state_protocol_and_option_two_server_update():
    params = {"w": torch.zeros(2, 3), "b": torch.zeros(3)}
    proto = SCAFFOLD_SPEC.client_state
    st = proto.init(params, 5)
    assert isinstance(st, ScaffoldState)
    assert tuple(st.c_clients["w"].shape) == (5, 2, 3)
    cohort = torch.tensor([1, 3])
    new = {"w": torch.ones(2, 2, 3), "b": torch.full((2, 3), 2.0)}
    diff = {"w": torch.full((2, 2, 3), 0.5), "b": torch.ones(2, 3)}
    st = proto.server_update(st, cohort, (new, diff), 5)
    # c <- c + (S/N) mean_i (c_i' - c_i)
    torch.testing.assert_close(st.c_global["w"], torch.full((2, 3), 0.2))
    torch.testing.assert_close(st.c_global["b"], torch.full((3,), 0.4))
    view_g, view_i = proto.client_view(st, cohort)
    torch.testing.assert_close(view_i["w"], new["w"])
    assert float(st.c_clients["w"][0].abs().sum()) == 0.0
    # spill hooks: only the private rows travel
    row = state_export(proto, st, 3)
    assert set(row) == {"w", "b"} and float(row["b"][0]) == 2.0
    st = state_import(proto, st, 0, row)
    torch.testing.assert_close(st.c_clients["b"][0], row["b"])
    rows = {"w": torch.full((2, 2, 3), 7.0), "b": torch.full((2, 3), 8.0)}
    st = state_import_many(proto, st, [2, 4], rows)
    assert float(st.c_clients["b"][4][0]) == 8.0


def test_composed_state_pairs_variates_with_residuals():
    qb = T.Transport(delta=T.QBlock(), theta=T.Dense())
    proto = round_client_state_spec(SCAFFOLD_SPEC, qb)
    params = {"w": torch.zeros(2, 3)}
    st = proto.init(params, 4)
    assert isinstance(st[0], ScaffoldState) and set(st[1]) == {"w"}
    rows = ({"w": torch.ones(2, 2, 3)}, {"w": torch.full((2, 2, 3), 3.0)})
    st = state_import_many(proto, st, [0, 2], rows)
    variates, residual = state_export(proto, st, 2)
    assert float(variates["w"].sum()) == 6.0
    assert float(residual["w"].sum()) == 18.0
    assert round_client_state_spec(SCAFFOLD_SPEC, T.Transport(
        T.Dense(), T.Dense())) is SCAFFOLD_SPEC.client_state


def test_custom_client_state_through_the_registry():
    """A new stateful algorithm needs only a spec: a per-client round
    counter, gathered and scattered by cohort."""
    def local_update(spec, lf, opt, run):
        base = make_local_update(dataclasses.replace(
            spec, local_update=None, client_state=None), lf, opt, run)

        def fn(p, theta, g, *, view, **kw):
            delta, theta_out, _, loss = base(p, theta, g, view=None, **kw)
            return delta, theta_out, view + 1, loss

        return fn

    state = ClientStateSpec(
        init=lambda p, n: torch.zeros((n,), dtype=torch.int32),
        client_view=lambda s, cid: s[cid],
        server_update=lambda s, cohort, outs, n: s.index_put_((cohort,),
                                                              outs))
    spec = AlgorithmSpec(name="counting_sgd", optimizer="sgd",
                         local_update=local_update, client_state=state)
    exp = build_experiment(spec, scenario="cifar_like_cnn", n_clients=4,
                           participation=1.0, rounds=2, local_steps=1,
                           device="cpu")
    exp.run()
    assert exp.client_state.tolist() == [2, 2, 2, 2]


# -------------------------------------------------------- mixing weights

def test_precond_mixing_weights_match_jax():
    r = np.random.default_rng(3)
    thetas = {"a": np.abs(r.standard_normal((4, 3, 5))).astype(np.float32),
              "b": {"c": r.standard_normal((4, 7)).astype(np.float32)}}
    want = jax_mixing(None, thetas)
    got = precond_mixing_weights(None, params_from_numpy(thetas, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert abs(float(got.mean()) - 1.0) < 1e-6
    with pytest.raises(ValueError, match="second-order"):
        precond_mixing_weights(None, {"m": None})


# ------------------------------------------------------------ histories

@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for key, (algo, kw, _, _) in RUNS.items():
        exp = jax_build(algo, scenario="cifar_like_cnn", rounds=ROUNDS, **kw)
        out[key] = (exp.run(), exp.comm_bytes_per_round(),
                    jax.tree.map(np.asarray, exp.scenario.params))
    return out


@pytest.mark.parametrize("key", list(RUNS))
def test_history_matches_jax(jax_runs, key):
    algo, kw, tol, rel = RUNS[key]
    want, want_bytes, jax_params = jax_runs[key]
    scn = materialize("cifar_like_cnn", seed=0, n_clients=10, device="cpu")
    scn = dataclasses.replace(scn, params=params_from_numpy(jax_params, "cpu"))
    exp = build_experiment(algo, scenario=scn, rounds=ROUNDS, device="cpu",
                           **kw)
    got = exp.run()
    assert len(got) == len(want) == ROUNDS
    for r, (w, g) in enumerate(zip(want, got)):
        for k in ("round", "upload_bytes", "upload_total_bytes",
                  "cohort_size", "beta", "freshness"):
            assert g[k] == w[k], (r, k)
        for k, t in {**tol, **rel}.items():
            assert np.isnan(g[k]) == np.isnan(w[k]), (r, k, w[k], g[k])
            bound = t * abs(w[k]) if k in rel else t
            if not np.isnan(w[k]):
                assert abs(w[k] - g[k]) <= bound, (r, k, w[k], g[k])
    assert exp.comm_bytes_per_round() == want_bytes
    if key == "fedpac_adamw_light":
        assert not np.isnan(got[0]["loss"]) and np.isnan(got[1]["loss"])
        one = tree_map(lambda x: x[None], exp.server.params)
        kinds = {m.kind for m in tree_leaves(exp.transport.theta.encode(
            one).leaves)}
        assert kinds == {"lowrank", "dense"}
    if algo == "scaffold":
        assert exp.lr == 1e-2 and got[0]["drift"] == 0.0


# ------------------------------------------------------- legacy entry points

def _round_inputs():
    """The tiny CNN's params from the reference, and (S=2, K=2) batches
    drawn once with numpy, for both packages."""
    jscn = jax_materialize("cifar_like_cnn", seed=0)
    rng = np.random.default_rng(1)
    per = [[jscn.client_batch_fn(c, rng) for _ in range(2)] for c in (0, 3)]
    batches = {k: np.stack([np.stack([np.asarray(b[k]) for b in row])
                            for row in per]) for k in ("x", "y")}
    return jscn, jax.tree.map(np.asarray, jscn.params), batches


@pytest.mark.parametrize("variant,compress", [("fedpac", False),
                                              ("fedsoa", False),
                                              ("fedpac", True)])
def test_make_round_fn_and_variants_match_jax(variant, compress):
    jscn, params, batches = _round_inputs()
    kw = dict(lr=5e-2, local_steps=2)
    jopt = jax_optim.make("sgd", momentum=0.9)
    topt = optim.make("sgd", momentum=0.9)
    if variant == "fedsoa":
        jfn = jax_fedsoa.make_fedsoa_round_fn(jscn.loss_fn, jopt, **kw)
    else:
        jfn = jax_fedsoa.make_variant_round_fn(
            variant, jscn.loss_fn, jopt, **kw, compress_fn=(
                jax_compression.make_svd_codec(4) if compress else None))
    js = jax_init_server(params, jopt)
    tscn = materialize("cifar_like_cnn", seed=0, device="cpu")
    if variant == "fedsoa":
        tfn = fedsoa.make_fedsoa_round_fn(tscn.loss_fn, topt, **kw)
    else:
        tfn = fedsoa.make_variant_round_fn(
            variant, tscn.loss_fn, topt, **kw, compress_fn=(
                compression.make_svd_codec(4) if compress else None))
    ts = init_server(params_from_numpy(params, "cpu"))
    tb = params_from_numpy(batches, "cpu")
    for r in range(2):
        js, jm = jfn(js, batches, jax.random.key(r))
        ts, tm = tfn(ts, tb, r)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    _assert_trees_close(js.params, ts.params, "params", rtol=1e-4,
                        atol=1e-5)
    assert "upload_bytes" not in tm and ts.round == 2
    assert fedsoa.VARIANTS == jax_fedsoa.VARIANTS


def test_light_variants_and_registry_match_the_reference():
    assert set(registered()) == set(jax_registered())
    for name in registered():
        light = resolve(f"{name}_light")
        want = jax_resolve(f"{name}_light")
        assert light.name == want.name == f"{name}_light"
        assert (light.upload, light.optimizer, light.align, light.correct,
                light.pinned_beta, light.default_lr) == (
            want.upload, want.optimizer, want.align, want.correct,
            want.pinned_beta, want.default_lr)
    fedcm = resolve("fedcm_light")
    assert fedcm.pinned_beta == 0.9 and fedcm.upload == "svd"
    assert fedcm.resolve_beta(0.1) == 0.9
    assert isinstance(fedcm.make_transport().theta, T.LowRankSVD)
    for name in ("scaffold", "fedpm_soap", "fedpm_sophia"):
        assert resolve(name).name == name
    assert resolve("scaffold").default_lr == jax_resolve("scaffold").default_lr
    with pytest.raises(ValueError, match="_light"):
        resolve("nope_light")


def test_compression_shims_and_comm_bytes_match_the_reference():
    r = np.random.default_rng(2)
    params = {"w": r.standard_normal((12, 20)).astype(np.float32),
              "b": r.standard_normal((77,)).astype(np.float32)}
    theta = {"L": r.standard_normal((16, 16)).astype(np.float32),
             "v": r.standard_normal((5,)).astype(np.float32)}
    tp, tt = params_from_numpy(params, "cpu"), params_from_numpy(theta,
                                                                  "cpu")
    for rank in (2, 8):
        assert compression.compressed_bytes(tt, rank) == \
            jax_compression.compressed_bytes(theta, rank)
        assert compression.round_comm_bytes(
            tp, tt, compressed_rank=rank) == jax_compression.round_comm_bytes(
            params, theta, compressed_rank=rank)
    assert compression.round_comm_bytes(tp) == \
        jax_compression.round_comm_bytes(params)
    for name in ("fedpac_soap_light", "fedavg", "scaffold"):
        assert resolve(name).comm_bytes(tp, tt, svd_rank=3) == \
            jax_resolve(name).comm_bytes(params, theta, svd_rank=3)
    mats = r.standard_normal((3, 9, 7)).astype(np.float32)
    np.testing.assert_allclose(
        compression.svd_truncate(torch.from_numpy(mats), 3).numpy(),
        np.asarray(jax_compression.svd_truncate(mats, 3)), atol=1e-5)
    u, _ = np.linalg.qr(r.standard_normal((2, 10, 6)))
    gapped = (u * np.asarray([5.0, 4.0, 0.1, 0.05, 0.02, 0.01])
              ) @ np.swapaxes(u[:, :8, :], 1, 2)
    stacked = {"m": gapped.astype(np.float32), "s": np.ones((2, 3),
                                                            np.float32)}
    want = jax_compression.make_svd_codec(2)(stacked)
    got = compression.make_svd_codec(2)(params_from_numpy(stacked, "cpu"))
    _assert_trees_close(want, got, "svd round-trip", rtol=0, atol=5e-5)


# ----------------------------------------------------------------- config

def test_fedconfig_low_rank_knobs_validate_and_reach_the_transport():
    cfg = FedConfig(device="cpu", svd_rank=3, sketch_iters=1,
                    wire_dtype="bf16", theta_codec="power_sketch+qblock")
    tr = cfg.make_transport(resolve("fedpac_soap"))
    sketch = tr.theta.stages[0]
    assert isinstance(tr.theta, T.Chain) and isinstance(sketch,
                                                        T.PowerSketch)
    assert (sketch.rank, sketch.iters, sketch.wire_dtype) == (3, 1, "bf16")
    assert isinstance(tr.delta, T.Dense) and tr.feedback_active
    light = FedConfig(device="cpu", svd_rank=5).make_transport(
        resolve("fedpac_soap_light"))
    assert isinstance(light.theta, T.LowRankSVD) and light.theta.rank == 5
    for bad in (dict(svd_rank=0), dict(sketch_iters=-1),
                dict(wire_dtype="fp8")):
        with pytest.raises(ValueError):
            FedConfig(device="cpu", **bad)
    with pytest.raises(T.UnknownCodecError):
        FedConfig(device="cpu", theta_codec="lowrank_svd+sketch")


def test_controllers_and_scenarios_need_a_device():
    for build in (lambda: make_controller(0.5),
                  lambda: fixed_controller(0.5),
                  lambda: auto_controller(0.7)):
        with pytest.raises(TypeError, match="device"):
            build()
    ctrl = make_controller("auto", device="cpu")
    assert ctrl.adaptive and ctrl.beta.device.type == "cpu"
    scn = materialize("cifar_like_cnn", seed=0, device="cpu")
    fields = {f.name: getattr(scn, f.name)
              for f in dataclasses.fields(Scenario) if f.name != "device"}
    with pytest.raises(TypeError, match="device"):
        Scenario(**fields)
