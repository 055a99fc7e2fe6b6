"""Public names the reference has and the port gained late, each against
the JAX package's: ``init_server(params, opt, g_dtype, geom)``,
``build_experiment(scenario_seed=)``, ``ScenarioSpec.with_partition``,
``register_vision_model``, ``catalog.DIR01``, ``parse_algorithm``,
``weighted_client_mean``/``normalized_client_mean``/``aggregate_round``,
``AlgorithmSpec.init_client_state``, ``LocalOptimizer.precond_multiplier``
and the ``utils.tree`` helpers.  ``tests/test_torch_imports.py`` guards
the names themselves; these tests hold what they compute.

Tolerances: structure, dtypes, names, errors and partitions exact; the
server update 1e-6 absolute and relative (f32 sums in other orders).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.api import build_experiment as jax_build
from repro.core import server as jax_server
from repro.core.algorithms import registered as jax_registered
from repro.core.algorithms import resolve as jax_resolve
from repro.core.engine import aggregation as jax_agg
from repro.fed import parse_algorithm as jax_parse
from repro.scenarios import catalog as jax_catalog
from repro.scenarios import materialize as jax_materialize
from repro.scenarios import spec as jax_spec
from repro.utils import tree as jax_tree
from repro_torch import optim
from repro_torch.api import build_experiment, materialize, resolve_scenario
from repro_torch.convert import params_from_numpy
from repro_torch.core import (
    aggregate_round, init_server, normalized_client_mean,
    weighted_client_mean,
)
from repro_torch.core.algorithms import registered, resolve
from repro_torch.core.engine import aggregate_round as engine_round
from repro_torch.fed import parse_algorithm
from repro_torch.scenarios import catalog, spec, vision
from repro_torch.utils import tree
from repro_torch.utils.tree import tree_flatten_with_path

TOL = dict(rtol=1e-6, atol=1e-6)


def _params(seed, lead=()):
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal(lead + (4, 3)).astype(np.float32),
            "b": [r.standard_normal(lead + (3,)).astype(np.float32)]}


def _close(want, got, **tol):
    w_leaves = jax.tree.leaves(want)
    g_leaves = [x for _, x in tree_flatten_with_path(got)]
    assert len(w_leaves) == len(g_leaves)
    for w, g in zip(w_leaves, g_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _signature_extends(ref_fn, port_fn):
    """The port's parameters start with the reference's, in order."""
    want = list(inspect.signature(ref_fn).parameters)
    got = list(inspect.signature(port_fn).parameters)
    assert got[:len(want)] == want, (want, got)


# ---------------------------------------------------------------- server

def test_init_server_binds_opt_as_the_reference():
    _signature_extends(jax_server.init_server, init_server)
    p = _params(0)
    want = jax_server.init_server(p, jax_optim.make("soap"))
    got = init_server(params_from_numpy(p, "cpu"), optim.make("soap"))
    assert got.geom is None and want.geom is None
    assert got.theta is None and got.round == got.theta_version == 0
    _close(want.g_global, got.g_global, rtol=0, atol=0)
    half = init_server(params_from_numpy(p, "cpu"), None, torch.bfloat16)
    assert {x.dtype for x in tree.tree_leaves(half.g_global)} == {
        torch.bfloat16}
    assert init_server(params_from_numpy(p, "cpu"), geom="g").geom == "g"


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_thetas", [False, True])
def test_aggregate_round_matches_reference(weighted, with_thetas):
    assert engine_round is aggregate_round
    params = _params(1)
    deltas, thetas = _params(2, (3,)), _params(3, (3,))
    weights = np.array([1.0, 0.5, 0.25], np.float32) if weighted else None
    kw = dict(lr=0.1, local_steps=4, server_lr=0.9)
    jserver = jax_server.init_server(params, None)
    jserver = jax_server.ServerState(jserver.params, _params(4),
                                     jserver.g_global, 3, 2)
    tserver = init_server(params_from_numpy(params, "cpu"))
    tserver.theta = params_from_numpy(_params(4), "cpu")
    tserver.round, tserver.theta_version = 3, 2
    want = jax_agg.aggregate_round(
        jserver, deltas, thetas if with_thetas else None,
        weights=None if weights is None else jnp.asarray(weights), **kw)
    got = aggregate_round(
        tserver, params_from_numpy(deltas, "cpu"),
        params_from_numpy(thetas, "cpu") if with_thetas else None,
        weights=None if weights is None else torch.from_numpy(weights), **kw)
    assert (got.round, got.theta_version) == (want.round,
                                              want.theta_version)
    assert got.theta_version == (4 if with_thetas else 2)
    for k in ("params", "theta", "g_global"):
        _close(getattr(want, k), getattr(got, k), **TOL)
    if not with_thetas:      # the geometry reference is left as it was
        assert got.theta is tserver.theta


def test_client_means_match_reference():
    x = _params(5, (4,))
    w = np.array([1.0, 0.2, 0.7, 0.4], np.float32)
    tx = params_from_numpy(x, "cpu")
    _close(jax_agg.weighted_client_mean(x), weighted_client_mean(tx), **TOL)
    _close(jax_agg.weighted_client_mean(x, jnp.asarray(w)),
           weighted_client_mean(tx, torch.from_numpy(w)), **TOL)
    _close(jax_agg.normalized_client_mean(x, jnp.asarray(w)),
           normalized_client_mean(tx, torch.from_numpy(w)), **TOL)


# ------------------------------------------------------------ algorithms

def test_parse_algorithm_matches_reference_for_every_name():
    names = list(registered())
    assert set(names) == set(jax_registered())
    for name in names + [f"{n}_light" for n in names]:
        assert parse_algorithm(name) == jax_parse(name), name


def test_init_client_state_matches_reference():
    p = _params(6)
    for name in ("scaffold", "fedpac_soap"):
        want = jax_resolve(name).init_client_state(p, 5)
        got = resolve(name).init_client_state(params_from_numpy(p, "cpu"), 5)
        if want is None:
            assert got is None
            continue
        assert type(got).__name__ == type(want).__name__
        for field in ("c_global", "c_clients"):
            _close(getattr(want, field), getattr(got, field), rtol=0, atol=0)


def test_precond_multiplier_matches_reference():
    for name, kw in (("sgd", {}), ("sgd", {"momentum": 0.9}), ("adamw", {}),
                     ("soap", {}), ("sophia", {}), ("muon", {})):
        assert optim.make(name, **kw).precond_multiplier == \
            jax_optim.make(name, **kw).precond_multiplier, (name, kw)


# ------------------------------------------------------------- scenarios

def test_with_partition_and_dir01_match_reference():
    assert catalog.DIR01 == spec.PartitionSpec("dirichlet", alpha=0.1)
    assert catalog.DIR01.tag() == jax_catalog.DIR01.tag()
    part = spec.PartitionSpec("shard", shards_per_client=2)
    jpart = jax_spec.PartitionSpec("shard", shards_per_client=2)
    for suffix in (None, "two"):
        got = resolve_scenario("cifar_like_cnn").with_partition(part, suffix)
        want = jax_catalog.cifar_like(name="cifar_like_cnn").with_partition(
            jpart, suffix)
        assert got.name == want.name
        assert got.partition == part
    derived = resolve_scenario("cifar_like_cnn").with_partition(
        catalog.DIR01)
    got = materialize(derived, seed=2, device="cpu")
    want = jax_materialize(jax_catalog.cifar_like(
        name="cifar_like_cnn").with_partition(jax_catalog.DIR01), seed=2)
    for w, g in zip(want.partitions, got.partitions):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_build_experiment_scenario_seed_matches_reference():
    got = build_experiment("fedavg", scenario="cifar_like_cnn",
                           scenario_seed=3, device="cpu", seed=0)
    want = jax_materialize("cifar_like_cnn", seed=3)
    assert got.scenario.seed == 3 and got.fed.seed == 0
    for w, g in zip(want.partitions, got.scenario.partitions):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # without it the config's seed materializes the scenario
    assert build_experiment("fedavg", scenario="cifar_like_cnn",
                            device="cpu", seed=4).scenario.seed == 4
    premade = materialize("cifar_like_cnn", seed=3, device="cpu")
    assert build_experiment("fedavg", scenario=premade, scenario_seed=3,
                            device="cpu").scenario is premade
    jpremade = jax_materialize("cifar_like_cnn", seed=3)
    for build, scn, extra in ((build_experiment, premade, {"device": "cpu"}),
                              (jax_build, jpremade, {})):
        with pytest.raises(ValueError, match="scenario_seed=5"):
            build("fedavg", scenario=scn, scenario_seed=5, **extra)
        with pytest.raises(ValueError, match="only applies together"):
            build("fedavg", scenario_seed=5, **extra)


def test_register_vision_model_adds_a_backbone():
    calls = []

    def tiny(seed, *, image_size, n_classes, device, width=4):
        calls.append((seed, image_size, n_classes, width))
        return vision._make_cnn(seed, image_size=image_size,
                                n_classes=n_classes, device=device,
                                width=width, blocks=1)

    assert vision.register_vision_model("tiny_cnn", tiny) is tiny
    try:
        scn = resolve_scenario("cifar_like_cnn").variant(
            "tiny", model="tiny_cnn", model_kwargs={"width": 4})
        got = materialize(scn, seed=1, device="cpu")
        assert calls == [(1, 12, 8, 4)]
        assert np.isfinite(float(got.eval_fn(got.params)["test_loss"]))
    finally:
        del vision.VISION_MODELS["tiny_cnn"]
    with pytest.raises(ValueError, match="register_vision_model"):
        materialize(scn, seed=1, device="cpu")


# ------------------------------------------------------------------ tree

def test_tree_helpers_match_reference():
    a, b = _params(7), _params(8)
    ta, tb = params_from_numpy(a, "cpu"), params_from_numpy(b, "cpu")
    pairs = [
        (jax_tree.tree_add(a, b), tree.tree_add(ta, tb)),
        (jax_tree.tree_sub(a, b), tree.tree_sub(ta, tb)),
        (jax_tree.tree_scale(a, 0.3), tree.tree_scale(ta, 0.3)),
        (jax_tree.tree_axpy(0.3, a, b), tree.tree_axpy(0.3, ta, tb)),
        (jax_tree.tree_lerp(a, b, 0.3), tree.tree_lerp(ta, tb, 0.3)),
        (jax_tree.tree_mean([a, b, a]), tree.tree_mean([ta, tb, ta])),
        (jax_tree.tree_zeros_like(a), tree.tree_zeros_like(ta)),
    ]
    stacked = _params(9, (3,))
    pairs.append((jax_tree.tree_stack_mean(stacked),
                  tree.tree_stack_mean(params_from_numpy(stacked, "cpu"))))
    for want, got in pairs:
        _close(want, got, **TOL)
    assert tree.tree_size(ta) == jax_tree.tree_size(a) == 15
    assert tree.tree_bytes(ta) == jax_tree.tree_bytes(a) == 60
    np.testing.assert_allclose(float(tree.global_norm(ta)),
                               float(jax_tree.global_norm(a)), rtol=1e-6)
    mixed = {"x": ta["w"], "i": torch.arange(3, dtype=torch.int32)}
    cast = tree.tree_cast(mixed, torch.bfloat16)
    assert cast["x"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int32
    want = jax_tree.tree_cast({"x": a["w"], "i": jnp.arange(3)},
                              jnp.bfloat16)
    assert str(want["x"].dtype) == "bfloat16"
    assert tree.tree_bytes(cast) == jax_tree.tree_bytes(want)
