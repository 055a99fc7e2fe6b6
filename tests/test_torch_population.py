"""The port's population layer against the JAX package: cohort samplers,
per-client generators and the lazy ``stream_dirichlet`` partition (numpy
copies: identical), population-mode round histories of ``fedpac_soap`` and
``scaffold`` with spills, the sparse store's invariants (spill/restore
byte-identical, sparse bitwise equal to dense on the sync and async
runtimes, a round invariant to the population size), config validation,
the lazy scenario, and the ``chunked``/``sharded`` executors against
``vmap``.  The problem is a one-block CNN (width 4) on 400 8x8 images
over a 64-id population, K=2, cohort 8, with the JAX-initialised params
carried in.

Tolerances:
  * cohorts, ``client_rng`` draws, partitions, slot maps, spill counts,
    upload bytes: exact.
  * ``fedpac_soap`` histories: SOAP's round tolerances at eps=1e-3
    (tests/test_torch_round.py): loss 5e-3 absolute, drift and
    norm_drift 5% relative.
  * ``scaffold`` histories: the first-order ones
    (tests/test_torch_algorithms.py): loss 1e-4 absolute.
  * sparse vs dense, population-size invariance, spill round trips:
    bitwise.
  * ``chunked``/``sharded`` vs ``vmap``: losses bitwise, parameters within
    1e-6 (a vmap over 3 clients and one over 8 may pick other CPU
    convolution blockings: 9.3e-10 observed).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import build_experiment as jax_build
from repro.data import stream_dirichlet_map as jax_stream_map
from repro.fed.population import (
    AvailabilitySampler as JaxAvail, ClientPopulation as JaxPop,
    WeightedSampler as JaxWeighted,
)
from repro.models.vision import (
    classification_loss as jax_loss, cnn_apply as jax_cnn,
    init_cnn as jax_init_cnn,
)
from repro_torch.api import AsyncConfig, build_experiment
from repro_torch.convert import params_from_numpy
from repro_torch.core.algorithms import (
    resolve, round_client_state_spec, state_export, state_import,
)
from repro_torch.core.engine import ExecutorConfig, make_cohort_executor
from repro_torch.core.scaffold import SCAFFOLD_SPEC
from repro_torch.data import (
    ClientIndexMap, make_image_classification, stream_dirichlet_map,
)
from repro_torch.fed import FedConfig
from repro_torch.fed.population import (
    AvailabilitySampler, ClientPopulation, ClientStateStore,
    DenseClientStore, UniformSampler, WeightedSampler, make_client_store,
    make_population,
)
from repro_torch.fed.staging import mark_thread_safe
from repro_torch.models.vision import classification_loss, cnn_apply
from repro_torch.scenarios import PartitionSpec, cifar_like, materialize
from repro_torch.utils.tree import tree_leaves, tree_map

POP = 1_000_000
SMALL_POP = 64
COHORT = 8
SOAP_TOL, SOAP_REL = {"loss": 5e-3}, {"drift": 0.05, "norm_drift": 0.05}
FIRST_TOL, FIRST_REL = {"loss": 1e-4}, {}
EXACT = ("upload_bytes", "cohort_size", "round", "state_peak",
         "state_spills", "state_restores", "state_resident")


@pytest.fixture(scope="module")
def problem():
    """One problem for both packages: numpy data, the same lazy partition
    (identical by construction), the JAX-initialised CNN."""
    X, y = make_image_classification(400, image_size=8, n_classes=4, seed=0,
                                     noise=1.0)
    parts = stream_dirichlet_map(y, SMALL_POP, alpha=0.3,
                                 samples_per_client=32, seed=0)
    jparams = jax_init_cnn(jax.random.key(0), n_classes=4, width=4, blocks=1)

    @mark_thread_safe
    def batch_fn(cid, rng):
        idx = rng.choice(parts[cid], size=4)
        return {"x": X[idx], "y": y[idx]}

    def jax_loss_fn(p, b):
        return jax_loss(jax_cnn(p, b["x"]), b["y"])

    def loss_fn(p, b):
        return classification_loss(cnn_apply(p, b["x"]), b["y"])

    return dict(jparams=jparams, batch_fn=batch_fn, jax_loss=jax_loss_fn,
                loss=loss_fn, X=X, y=y)


def _params(problem):
    return params_from_numpy(jax.tree.map(np.asarray, problem["jparams"]),
                             "cpu")


def _run(problem, algo="scaffold", rounds=3, pop=SMALL_POP, **kw):
    exp = build_experiment(
        algo, params=_params(problem), loss_fn=problem["loss"],
        client_batch_fn=problem["batch_fn"], rounds=rounds, local_steps=2,
        population_size=pop, cohort_size=COHORT, seed=0, device="cpu", **kw)
    return exp, exp.run()


def _run_jax(problem, algo, rounds=3, **kw):
    exp = jax_build(
        algo, params=problem["jparams"], loss_fn=problem["jax_loss"],
        client_batch_fn=problem["batch_fn"], rounds=rounds, local_steps=2,
        population_size=SMALL_POP, cohort_size=COHORT, seed=0, **kw)
    return exp, exp.run()


# ----------------------------------------------------------------- samplers

def _samplers(pkg):
    w = np.ones(100)
    w[:5] = 1000.0
    table = np.array([0.2, 0.7, 0.4])
    if pkg == "jax":
        return {"uniform": (POP, None),
                "weighted": (100, JaxWeighted(lambda ids: w[ids])),
                "availability": (1000, JaxAvail.from_hourly(table))}
    return {"uniform": (POP, UniformSampler()),
            "weighted": (100, WeightedSampler(lambda ids: w[ids])),
            "availability": (1000, AvailabilitySampler.from_hourly(table))}


@pytest.mark.parametrize("kind", ["uniform", "weighted", "availability"])
def test_cohorts_match_reference(kind):
    jsize, jsampler = _samplers("jax")[kind]
    tsize, tsampler = _samplers("torch")[kind]
    jpop = JaxPop(jsize, seed=7, sampler=jsampler)
    tpop = ClientPopulation(tsize, seed=7, sampler=tsampler)
    for r in range(4):
        want = jpop.sample_cohort(r, 16)
        got = tpop.sample_cohort(r, 16)
        assert got.tolist() == want.tolist()
        assert len(np.unique(got)) == 16
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        assert (tpop.sample_dispatch(rng_t, exclude={1, 2}, t=1)
                == jpop.sample_dispatch(rng_j, exclude={1, 2}, t=1))


def test_client_rng_matches_reference_and_ignores_population_size():
    jpop = JaxPop(POP, seed=9)
    for size in (50, POP):
        pop = ClientPopulation(size, seed=9)
        for cid in (0, 17, 49):
            got = pop.client_rng(cid, salt=3).integers(0, 2**31, 6)
            want = jpop.client_rng(cid, salt=3).integers(0, 2**31, 6)
            assert got.tolist() == want.tolist()


def test_client_seeds_are_per_client_and_population_invariant():
    small, large = ClientPopulation(50, seed=1), ClientPopulation(POP, seed=1)
    seeds = [large.client_key(c, salt=2) for c in (0, 17, 49)]
    assert seeds == [small.client_key(c, salt=2) for c in (0, 17, 49)]
    assert len(set(seeds)) == 3
    assert all(isinstance(s, int) and 0 <= s < 2**63 for s in seeds)
    assert large.client_key(17, salt=3) != seeds[1]      # salted
    cohort = large.sample_cohort(0, 6)
    assert large.cohort_keys(cohort, salt=2).tolist() == [
        large.client_key(int(c), salt=2) for c in cohort]
    assert large.cohort_keys(cohort[::-1], salt=2).tolist() == \
        large.cohort_keys(cohort, salt=2)[::-1].tolist()
    assert ClientPopulation(POP, seed=2).client_key(0) != large.client_key(0)


def test_sampler_behaviour_and_bad_ids():
    pop = ClientPopulation(8, seed=0, sampler=UniformSampler())
    assert sorted(pop.sample_cohort(0, 8).tolist()) == list(range(8))
    even = ClientPopulation(1000, seed=0, sampler=AvailabilitySampler(
        lambda ids, t: ids % 2 == 0))
    assert (even.sample_cohort(0, 16) % 2 == 0).all()
    with pytest.raises(ValueError):
        pop.sample_cohort(0, 9)
    with pytest.raises(ValueError):
        pop.client_rng(8)
    with pytest.raises(ValueError):
        pop.client_key(-1)


# --------------------------------------------------------- lazy partitions

def test_stream_dirichlet_map_matches_reference_and_is_lazy():
    y = np.repeat(np.arange(4), 25)
    got = stream_dirichlet_map(y, POP, alpha=0.3, samples_per_client=16,
                               seed=2)
    want = jax_stream_map(y, POP, alpha=0.3, samples_per_client=16, seed=2)
    small = stream_dirichlet_map(y, 10, alpha=0.3, samples_per_client=16,
                                 seed=2)
    assert isinstance(got, ClientIndexMap) and len(got) == POP
    for cid in (0, 9, 123456, POP - 1):
        assert got[cid].tolist() == want[cid].tolist()
    for cid in (0, 9):
        assert got[cid].tolist() == small[cid].tolist()
    with pytest.raises(IndexError):
        small[10]
    assert got.sample_stats(y) == want.sample_stats(y)
    assert got.sample_stats(y)["lazy"]


def test_stream_scenario_materializes_over_a_large_id_space():
    spec = cifar_like(
        model="cnn", n=600, image_size=8, n_classes=4, batch=8,
        n_clients=POP, name="pop_test",
        partition=PartitionSpec("stream_dirichlet", alpha=0.3,
                                samples_per_client=16))
    assert spec.partition.lazy and spec.partition.tag() == "sdir0.3"
    scn = materialize(spec, seed=0, n_clients=POP, device="cpu")
    assert isinstance(scn.partitions, ClientIndexMap)
    assert scn.partition_stats["lazy"]
    assert scn.client_batch_fn(999_999, np.random.default_rng(0))[
        "x"].shape[0] == 8
    eager = materialize(cifar_like(model="cnn", n=600, image_size=8,
                                   n_classes=4, alpha=0.3, batch=8,
                                   n_clients=6, name="eager_test"),
                        seed=0, n_clients=6, device="cpu")
    assert isinstance(eager.partitions, list) and len(eager.partitions) == 6
    with pytest.raises(ValueError, match="samples_per_client"):
        PartitionSpec("stream_dirichlet", samples_per_client=0)


# -------------------------------------------------------------- state store

def _store(tmp_path, budget=4, pop=100):
    params = {"w": torch.zeros((3, 2)), "b": torch.zeros(2)}
    proto = round_client_state_spec(resolve("scaffold"))
    return ClientStateStore(proto, params, pop, budget,
                            spill_dir=str(tmp_path)), proto


def test_store_spill_restore_roundtrip_bitwise(tmp_path):
    store, proto = _store(tmp_path, budget=2)
    (slot,) = store.acquire([11])
    marked = tree_map(lambda x: x + 3.25,
                      state_export(proto, store.state, int(slot)))
    store.state = state_import(proto, store.state, int(slot), marked)
    store.acquire([5])
    store.acquire([7])                 # evicts 11: spilled to disk
    assert store.spills == 1
    assert os.path.exists(tmp_path / f"client_{11:012d}.npz")
    (slot2,) = store.acquire([11])     # restored
    back = state_export(proto, store.state, int(slot2))
    for a, b in zip(tree_leaves(marked), tree_leaves(back)):
        assert torch.equal(a, b)
    assert store.restores == 1
    assert not os.path.exists(tmp_path / f"client_{11:012d}.npz")


def test_store_group_spill_restores_from_archive_and_in_flight(tmp_path):
    """The streaming path: a deferred acquire's evictions leave as one
    group file; a row restores from the in-memory export while the write
    is pending and from the archive after it, byte for byte."""
    store, proto = _store(tmp_path, budget=3)
    slots = store.acquire([1, 2, 3], defer_restore=True)
    store.collect_pending([1, 2, 3])
    for c, s in zip((1, 2, 3), slots):
        store.state = state_import(
            proto, store.state, int(s),
            tree_map(lambda x: torch.full_like(x, float(c)),
                     state_export(proto, store.state, int(s))))
    store.acquire([4, 5], defer_restore=True)    # evicts 1, 2 as a group
    assert store.spills == 2
    store.collect_pending([4, 5])
    store.flush_io()
    assert [p.name for p in tmp_path.iterdir()] == ["group_00000000.npz"]
    store.acquire([1, 2], defer_restore=True)    # evicts 3, 4
    store.prefetch([1, 2])
    slots, rows = store.collect_pending([1, 2])
    assert store.restores == 2
    for i, c in enumerate((1, 2)):
        assert all(bool((x[i] == c).all()) for x in tree_leaves(rows))
    store.flush_io()
    assert [p.name for p in tmp_path.iterdir()] == ["group_00000001.npz"]
    # restore 3 straight from the in-flight export of group 1
    store.acquire([3], defer_restore=True)
    _, rows = store.collect_pending([3])
    assert all(bool((x[0] == 3).all()) for x in tree_leaves(rows))
    assert store.evict_client(4) and not store.evict_client(99)


def test_store_budget_peak_and_dense_identity(tmp_path):
    store, _ = _store(tmp_path, budget=3)
    with pytest.raises(ValueError):
        store.acquire([1, 2, 3, 4])            # cohort > budget
    with pytest.raises(ValueError):
        store.acquire([1, 1])                  # duplicate ids
    store.acquire([1, 2])
    store.acquire([3])
    store.acquire([4, 5, 6])
    assert store.peak_resident == store.resident == 3
    params = {"w": torch.zeros(3)}
    proto = round_client_state_spec(resolve("scaffold"))
    assert make_client_store(None, params, 6) is None
    dense = make_client_store(proto, params, 6, budget=6,
                              spill_dir=str(tmp_path))
    assert isinstance(dense, DenseClientStore)
    assert dense.acquire([4, 0, 2]).tolist() == [4, 0, 2]
    assert dense.spills == 0 and dense.collect_pending([4]) is None


def test_scaffold_export_import_only_touches_client_rows():
    params = {"w": torch.zeros((2, 2))}
    state = SCAFFOLD_SPEC.client_state.init(params, 3)
    row = SCAFFOLD_SPEC.client_state.client_export(state, 1)
    assert set(row) == set(params)
    out = SCAFFOLD_SPEC.client_state.client_import(
        state, 1, tree_map(lambda x: x + 1.0, row))
    assert torch.equal(out.c_global["w"], torch.zeros((2, 2)))
    assert torch.equal(out.c_clients["w"][1], torch.ones((2, 2)))


# ------------------------------------------------------------ config knobs

def test_fedconfig_population_validation():
    with pytest.raises(ValueError):             # pop knobs without pop size
        FedConfig(cohort_size=8, device="cpu")
    with pytest.raises(ValueError):             # pop size needs cohort size
        FedConfig(population_size=100, device="cpu")
    with pytest.raises(ValueError):             # cohort > population
        FedConfig(population_size=4, cohort_size=8, device="cpu")
    with pytest.raises(ValueError):             # budget < cohort
        FedConfig(population_size=100, cohort_size=8, state_budget=4,
                  device="cpu")
    with pytest.raises(ValueError):             # unknown sampler
        FedConfig(population_size=100, cohort_size=8, cohort_sampler="x",
                  device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        FedConfig(executor="chunked", chunk_size=0, device="cpu")
    cfg = FedConfig(population_size=100, cohort_size=8, device="cpu")
    assert cfg.population_active and cfg.resolve_state_budget() == 32
    assert not FedConfig(device="cpu").population_active
    pop = make_population(FedConfig(population_size=1234, cohort_size=8,
                                    seed=5, device="cpu"))
    assert pop.size == 1234 and len(pop.sample_cohort(0, 8)) == 8


def test_population_mode_runs_on_the_card_by_default(problem):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_experiment("fedavg", params=_params(problem),
                         loss_fn=problem["loss"],
                         client_batch_fn=problem["batch_fn"],
                         population_size=SMALL_POP, cohort_size=COHORT)


# ------------------------------------------------ histories vs reference

def _check(want, got, tol, rel):
    assert len(want) == len(got)
    for r, (w, g) in enumerate(zip(want, got)):
        assert {k for k in EXACT if k in w} == {k for k in EXACT if k in g}
        for k in EXACT:
            if k in w:
                assert w[k] == g[k], (r, k, w[k], g[k])
        for k, t in tol.items():
            assert abs(w[k] - g[k]) <= t, (r, k, w[k], g[k])
        for k, t in rel.items():
            assert abs(w[k] - g[k]) <= t * abs(w[k]), (r, k, w[k], g[k])


@pytest.mark.parametrize("algo,kw,tol,rel", [
    ("fedpac_soap", dict(opt_kwargs={"eps": 1e-3}), SOAP_TOL, SOAP_REL),
    ("scaffold", dict(state_budget=COHORT), FIRST_TOL, FIRST_REL),
])
def test_population_history_matches_reference(problem, tmp_path, algo, kw,
                                               tol, rel):
    _, want = _run_jax(problem, algo, spill_dir=str(tmp_path / "j"), **kw)
    _, got = _run(problem, algo, spill_dir=str(tmp_path / "t"), **kw)
    _check(want, got, tol, rel)
    if algo == "scaffold":
        assert got[-1]["state_spills"] > 0 and got[-1]["state_peak"] <= 8


# ------------------------------------------------------- port invariants

def test_sync_sparse_bitwise_equals_dense_with_spill(problem, tmp_path):
    """scaffold on the qblock wire with error feedback (both states);
    budget = cohort spills and restores, budget = population never does."""
    kw = dict(delta_codec="qblock", rounds=4)
    _, sparse = _run(problem, state_budget=COHORT,
                     spill_dir=str(tmp_path / "a"), **kw)
    _, dense = _run(problem, state_budget=SMALL_POP,
                    spill_dir=str(tmp_path / "b"), **kw)
    assert sparse[-1]["state_spills"] > 0 and sparse[-1]["state_restores"]
    assert dense[-1]["state_spills"] == 0
    for rs, rd in zip(sparse, dense):
        assert (rs["loss"], rs["drift"]) == (rd["loss"], rd["drift"])


def test_round_invariant_to_population_size(problem):
    def run(size):
        exp = build_experiment(
            "fedpac_sophia", params=_params(problem),
            loss_fn=problem["loss"], client_batch_fn=problem["batch_fn"],
            rounds=1, local_steps=2, population_size=size, cohort_size=4,
            seed=0, device="cpu", delta_codec="qblock")
        exp.population.sample_cohort = \
            lambda r, k: np.array([3, 11, 25, 39])
        return exp.run()[-1], exp.server.params

    (ra, pa), (rb, pb) = run(40), run(POP)
    assert (ra["loss"], ra["drift"]) == (rb["loss"], rb["drift"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pa),
                                                  tree_leaves(pb)))


def _run_async(problem, budget, tmp_path, pop=40):
    def batch_fn(cid, rng):        # the partition covers SMALL_POP ids
        return problem["batch_fn"](cid % SMALL_POP, rng)

    exp = build_experiment(
        "fedpac_sophia", params=_params(problem), loss_fn=problem["loss"],
        client_batch_fn=batch_fn, rounds=3, local_steps=2,
        runtime="async", delta_codec="qblock", population_size=pop,
        cohort_size=4, state_budget=budget, spill_dir=str(tmp_path), seed=0,
        device="cpu", async_cfg=AsyncConfig(buffer_size=2, concurrency=4))
    return exp, exp.run()


def test_async_sparse_bitwise_equals_dense_with_spill(problem, tmp_path):
    _, sparse = _run_async(problem, 4, tmp_path / "a")
    _, dense = _run_async(problem, 40, tmp_path / "b")
    assert sparse[-1]["state_spills"] > 0
    for rs, rd in zip(sparse, dense):
        for k in ("loss", "drift", "staleness", "sim_time"):
            assert rs[k] == rd[k], k
    assert sparse[-1]["state_peak"] <= 4


def test_async_scheduler_uses_stable_global_ids(problem, tmp_path):
    exp, _ = _run_async(problem, 8, tmp_path, pop=POP)
    seen = exp.scheduler._dispatch_counts.keys()
    assert seen and all(0 <= cid < POP for cid in seen)
    assert any(cid >= SMALL_POP for cid in seen)


def test_legacy_dense_path_unchanged_by_population_code(problem):
    exp = build_experiment("scaffold", params=_params(problem),
                           loss_fn=problem["loss"],
                           client_batch_fn=problem["batch_fn"], n_clients=6,
                           participation=0.5, rounds=2, local_steps=2,
                           seed=0, device="cpu")
    hist = exp.run()
    assert exp.population is None and exp.state_store is None
    assert "state_peak" not in hist[-1]


# ---------------------------------------------------------------- executors

@pytest.mark.parametrize("backend", ["chunked", "sharded", "shard_map"])
def test_executors_match_vmap(problem, backend):
    e0, h0 = _run(problem, "fedpac_sophia", rounds=2)
    e1, h1 = _run(problem, "fedpac_sophia", rounds=2, executor=backend,
                  chunk_size=3)
    assert [r["loss"] for r in h0] == [r["loss"] for r in h1]
    for a, b in zip(tree_leaves(e0.server.params),
                    tree_leaves(e1.server.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_chunked_executor_joins_a_ragged_tail():
    def one(x, k):
        return torch.sin(x) * (k + 1), x.sum() + k

    xs = torch.randn(8, 5, generator=torch.Generator().manual_seed(0))
    ks = torch.arange(8.0)
    want = torch.func.vmap(one)(xs, ks)
    for backend in ("chunked", "sharded"):
        got = make_cohort_executor(ExecutorConfig(backend=backend,
                                                  chunk_size=3))(one, xs, ks)
        for a, b in zip(want, got):
            assert torch.equal(a, b)


def test_multi_device_mesh_is_not_ported():
    # a multi-rank mesh is a torch.distributed DeviceMesh (held in
    # tests/test_torch_mesh.py); anything else that is not None or 1 raises
    class Mesh:
        def size(self):
            return 4

    for backend in ("shard_map", "sharded"):
        with pytest.raises(ValueError, match="DeviceMesh"):
            make_cohort_executor(ExecutorConfig(backend=backend, mesh=Mesh()))
    one = make_cohort_executor(ExecutorConfig(backend="sharded", mesh=1))
    assert torch.equal(one(torch.sin, torch.ones(3)), torch.sin(
        torch.ones(3)))
