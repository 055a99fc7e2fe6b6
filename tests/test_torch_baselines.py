"""The port's first-order baselines against the JAX package: SGD (with and
without momentum) and AdamW over K steps, 3-round ``fedavg`` and
``fedcm`` histories on ``cifar_like_cnn``, the learning-rate and beta
rules (``resolve_lr``, ``AlgorithmSpec.resolve_beta``), the shard and
quantity partitions, and the ``cifar_like_cnn_shard`` scenario.

Tolerances:
  * SGD: 1e-6 absolute + 1e-6 relative (the same f32 elementwise
    expressions); AdamW: 2e-6 absolute + 1e-5 relative (a division and a
    square root, and bias corrections computed in double here, in f32
    there).
  * The 3-round histories (as tests/test_torch_sophia.py holds Sophia):
    loss and test_loss 1e-4, test_acc 2/768, upload bytes and beta
    exact; drift and norm_drift are 0 on both sides (SGD's Theta has no
    leaves).  The port agrees to ~5e-7.
  * Partitions: bitwise.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.api import build_experiment as jax_build
from repro.core.algorithms import (
    AlgorithmSpec as JaxSpec, resolve as jax_resolve,
)
from repro.data import partition as jax_partition
from repro.fed.rounds import (
    FedConfig as JaxFedConfig, resolve_lr as jax_resolve_lr,
)
from repro.scenarios import (
    PartitionSpec as JaxPartitionSpec, materialize as jax_materialize,
)
from repro_torch import optim
from repro_torch.api import (
    AlgorithmSpec, PartitionSpec, build_experiment, materialize, registered,
    resolve, resolve_scenario,
)
from repro_torch.convert import params_from_numpy
from repro_torch.core.drift import drift_metric
from repro_torch.data import partition
from repro_torch.fed.rounds import FedConfig, resolve_lr
from repro_torch.utils.tree import tree_flatten_with_path

K = 4
ROUNDS = 3
HIST_TOL = {"loss": 1e-4, "test_loss": 1e-4, "test_acc": 2 / 768}

SHAPES = {"w": (12, 20), "stem": (3, 3, 2, 8), "bias": (20,),
          "head": {"w": (20, 5)}}


def _params(seed, lead=()):
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: r.standard_normal((*lead, *s)).astype(np.float32), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))


def _assert_trees_close(want_tree, got_tree, what, rtol, atol):
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = tree_flatten_with_path(got_tree)
    assert len(want) == len(got), what
    for (wp, w), (gp, g) in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {gp}")


@pytest.mark.parametrize("name,kw,tol", [
    ("sgd", {}, (1e-6, 1e-6)),
    ("sgd", {"momentum": 0.9}, (1e-6, 1e-6)),
    ("sgd", {"momentum": 0.9, "weight_decay": 0.01}, (1e-6, 1e-6)),
    ("adamw", {}, (1e-5, 2e-6)),
    ("adamw", {"b2": 0.95, "weight_decay": 0.01}, (1e-5, 2e-6)),
], ids=["sgd", "sgd-momentum", "sgd-momentum-wd", "adamw", "adamw-wd"])
def test_k_steps_match_jax_vmapped(name, kw, tol):
    """One stacked update over S=2 clients equals the reference vmapped
    over the client axis, step by step, directions and Theta."""
    rtol, atol = tol
    jopt, topt = jax_optim.make(name, **kw), optim.make(name, **kw)
    p = _params(0, lead=(2,))
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
        _assert_trees_close(jd, td, f"direction step {k}", rtol, atol)
        _assert_trees_close(jopt.get_precond(jst), topt.get_precond(tst),
                            f"theta step {k}", rtol, atol)


def test_sgd_without_momentum_has_a_theta_with_no_leaves():
    opt = optim.make("sgd")
    tp = params_from_numpy(_params(0, lead=(2,)), "cpu")
    st = opt.init(tp, lead=1)
    assert opt.get_precond(st) == {"m": None}
    assert opt.set_precond(st, {"m": None}) == {"m": None}
    zero = drift_metric(opt.get_precond(st), torch.device("cpu"))
    assert zero.shape == () and float(zero) == 0.0


def test_registry_lists_every_optimizer_and_baseline():
    assert optim.available() == ("adamw", "muon", "sgd", "soap", "sophia")
    names = set(registered())
    for opt_name in optim.available():
        for kind in ("local", "fedpac", "align_only", "correct_only"):
            assert f"{kind}_{opt_name}" in names
    assert {"fedavg", "fedcm"} <= names
    for name in ("fedavg", "fedcm", "local_muon", "fedpac_muon"):
        want, got = jax_resolve(name), resolve(name)
        assert (got.optimizer, got.align, got.correct, got.pinned_beta,
                got.default_lr) == (want.optimizer, want.align, want.correct,
                                    want.pinned_beta, want.default_lr)
    assert optim.DEFAULT_LR == jax_optim.DEFAULT_LR


@pytest.mark.parametrize("fields,requested", [
    ({"correct": False}, 0.3),
    ({"correct": True}, 0.3),
    ({"correct": True}, "auto"),
    ({"correct": True, "pinned_beta": 0.9}, 0.3),
    ({"correct": True, "pinned_beta": 0.9}, "auto"),
    ({"correct": False, "pinned_beta": 0.9}, 0.3),
])
def test_resolve_beta_matches_reference(fields, requested):
    want = JaxSpec(name="x", **fields).resolve_beta(requested)
    assert AlgorithmSpec(name="x", **fields).resolve_beta(requested) == want


def test_fedcm_pins_beta_whatever_the_config_asks():
    for beta in (0.0, 0.5, "auto"):
        exp = build_experiment("fedcm", scenario="cifar_like_cnn", rounds=1,
                               beta=beta, device="cpu")
        assert float(exp.server.geom.beta) == pytest.approx(0.9)
        assert not exp.server.geom.adaptive


@pytest.mark.parametrize("lr,spec_fields,target", [
    (0.0, {}, "spec"),                       # a falsy fed.lr still wins
    (0.05, {"default_lr": 0.2}, "spec"),     # fed.lr beats the spec
    (None, {"default_lr": 0.2}, "spec"),     # then the spec's default_lr
    (None, {"optimizer": "muon"}, "spec"),   # then the table
    (None, {"optimizer": "sgd"}, "spec"),
    (None, {}, "adamw"),                     # a name: the table
    (None, {}, "unknown"),                   # a name off the table: 1e-2
])
def test_resolve_lr_matches_reference(lr, spec_fields, target):
    if target == "spec":
        want = jax_resolve_lr(JaxFedConfig(lr=lr),
                              JaxSpec(name="x", **spec_fields))
        got = resolve_lr(FedConfig(lr=lr, device="cpu"),
                         AlgorithmSpec(name="x", **spec_fields))
    else:
        want = jax_resolve_lr(JaxFedConfig(lr=lr), target)
        got = resolve_lr(FedConfig(lr=lr, device="cpu"), target)
    assert got == want


# ------------------------------------------------------------ partitions

@pytest.mark.parametrize("n_clients,shards,seed", [(10, 2, 0), (7, 3, 5),
                                                   (20, 1, 1)])
def test_shard_partition_is_the_reference_bit_for_bit(n_clients, shards,
                                                      seed):
    labels = np.random.default_rng(seed).integers(0, 8, 600)
    want = jax_partition.shard_partition(labels, n_clients, shards, seed)
    got = partition.shard_partition(labels, n_clients, shards, seed)
    assert len(got) == len(want) == n_clients
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("n_clients,alpha,seed,min_size", [
    (10, 0.5, 0, 1), (8, 0.1, 3, 5), (16, 2.0, 1, 1)])
def test_quantity_partition_is_the_reference_bit_for_bit(n_clients, alpha,
                                                         seed, min_size):
    want = jax_partition.quantity_partition(600, n_clients, alpha, seed,
                                            min_size)
    got = partition.quantity_partition(600, n_clients, alpha, seed, min_size)
    assert len(got) == len(want) == n_clients
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert sum(map(len, got)) == 600 and min(map(len, got)) >= min_size


@pytest.mark.parametrize("fn,args", [
    (partition.shard_partition, (np.zeros(10, int), 4, 3)),
    (partition.shard_partition, (np.zeros(10, int), 4, 0)),
    (partition.quantity_partition, (10, 4, 0.0)),
    (partition.quantity_partition, (10, 4, 0.5, 0, 3)),
])
def test_partitions_reject_infeasible_requests(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


@pytest.mark.parametrize("kind,kw", [
    ("shard", {"shards_per_client": 3}), ("quantity", {"alpha": 0.5}),
    ("quantity", {"alpha": 0.2, "min_size": 4}), ("dirichlet", {}),
    ("iid", {})])
def test_partition_spec_builds_and_tags_as_the_reference(kind, kw):
    labels = np.random.default_rng(9).integers(0, 8, 500)
    want_spec = JaxPartitionSpec(kind, **kw)
    got_spec = PartitionSpec(kind, **kw)
    assert got_spec.tag() == want_spec.tag()
    want = want_spec.build(labels, len(labels), 10, seed=4)
    got = got_spec.build(labels, len(labels), 10, seed=4)
    assert len(got) == len(want) == 10
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_cifar_like_cnn_shard_resolves_and_splits_as_the_reference():
    spec = resolve_scenario("cifar_like_cnn_shard")
    assert spec.partition.kind == "shard"
    assert spec.partition.tag() == "shard2"
    want = jax_materialize("cifar_like_cnn_shard", seed=3)
    got = materialize("cifar_like_cnn_shard", seed=3, device="cpu")
    assert len(got.partitions) == len(want.partitions)
    for w, g in zip(want.partitions, got.partitions):
        np.testing.assert_array_equal(g, w)
    assert got.partition_stats == pytest.approx(want.partition_stats)


# ------------------------------------------------------------ whole slice

@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for algo in ("fedavg", "fedcm"):
        exp = jax_build(algo, scenario="cifar_like_cnn", rounds=ROUNDS)
        out[algo] = (exp.run(), exp.comm_bytes_per_round(),
                     jax.tree.map(np.asarray, exp.scenario.params))
    return out


@pytest.mark.parametrize("algo", ["fedavg", "fedcm"])
def test_baseline_history_matches_jax(jax_runs, algo):
    want, want_bytes, jax_params = jax_runs[algo]
    scn = materialize("cifar_like_cnn", seed=0, n_clients=10, device="cpu")
    scn = dataclasses.replace(scn, params=params_from_numpy(jax_params, "cpu"))
    exp = build_experiment(algo, scenario=scn, rounds=ROUNDS, device="cpu")
    assert exp.lr == 0.1
    got = exp.run()
    assert len(got) == len(want) == ROUNDS
    for r, (w, g) in enumerate(zip(want, got)):
        for k, tol in HIST_TOL.items():
            assert abs(w[k] - g[k]) <= tol, (r, k, w[k], g[k])
        for k in ("round", "upload_bytes", "upload_total_bytes",
                  "cohort_size", "beta", "freshness", "drift",
                  "norm_drift"):
            assert g[k] == w[k], k
    assert exp.comm_bytes_per_round() == want_bytes
    assert got[0]["beta"] == pytest.approx(0.9 if algo == "fedcm" else 0.0)
