"""The port's chunk-streaming pipeline and streamed aggregation, against
the JAX package and its own serial round: ``stream_chunk``/
``finish_stream`` (single chunk bitwise equal to ``aggregate_wire``,
multi-chunk close to it and to the reference's stream), the carry
operand of ``dequant_accumulate`` on the CPU path, the pipelined round
(single chunk bitwise equal to the serial round; multi-chunk invariant to
the stager worker count, close to the serial round and to the reference's
pipeline; spills and restores bitwise), the round-owned write state,
config validation, the mixing-hook fallback, the chunk spans, and the
staging buffers' reuse and thread-safety contract.  The problem is the
one-block CNN of tests/test_torch_population.py over a 64-id population,
K=2, cohort 8.

Tolerances:
  * single chunk vs ``aggregate_wire`` and vs the serial round, worker
    counts, spills, the carry operand: bitwise.
  * multi-chunk stream vs ``aggregate_wire`` and vs the reference's
    stream: 1e-6 absolute + 1e-5 relative (the same f32 sums in another
    order); drift 1e-4 relative (the decomposed form subtracts two sums).
  * multi-chunk pipelined rounds vs the serial round and vs the
    reference's pipeline (``scaffold``): loss 1e-5 relative, parameters
    1e-5 relative + 1e-7 absolute (the reference's own margin).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_experiment as jax_build
from repro.core.engine import (
    AggregationConfig as JaxAggCfg, finish_stream as jax_finish,
    stream_chunk as jax_stream,
)
from repro.core.transport import Dense as JaxDense, Transport as JaxTransport
from repro.models.vision import (
    classification_loss as jax_loss, cnn_apply as jax_cnn,
    init_cnn as jax_init_cnn,
)
from repro_torch.api import build_experiment
from repro_torch.convert import params_from_numpy
from repro_torch.core import transport as T
from repro_torch.core.engine import (
    AggregationConfig, aggregate_wire, finish_stream, stream_chunk,
)
from repro_torch.data import make_image_classification, stream_dirichlet_map
from repro_torch.fed import FedConfig
from repro_torch.fed.staging import (
    StagingBuffers, is_thread_safe, mark_thread_safe,
    serialized_unless_thread_safe,
)
from repro_torch.kernels.fused_agg.kernel import (
    dequant_accumulate, dequant_accumulate_group,
    dequant_accumulate_group_plain,
)
from repro_torch.kernels.qblock.kernel import quantize
from repro_torch.models.vision import classification_loss, cnn_apply
from repro_torch.obs import MemorySink, attach, validate_event
from repro_torch.utils.tree import tree_leaves, tree_map

POP = 64
B = 6
CFG = AggregationConfig(lr=0.05, local_steps=4)


# ------------------------------------------------- streamed aggregation

def _np(seed, lead=()):
    r = np.random.default_rng(seed)
    return {"M": r.standard_normal((*lead, 9, 7)).astype(np.float32),
            "v": r.standard_normal((*lead, 5)).astype(np.float32)}


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _server():
    params = _np(11)
    theta = tree_map(lambda x: 0.1 * np.abs(x), params)
    g = tree_map(np.zeros_like, params)
    return params, theta, g


def _tp(name):
    codec = T.resolve_codec(name, T.TransportConfig(rank=3))
    return T.Transport(codec, codec)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


@pytest.mark.parametrize("name", ["dense", "qblock"])
def test_stream_single_chunk_bitwise_equals_aggregate_wire(name):
    params, theta, g = (_t(x) for x in _server())
    tp = _tp(name)
    dmsgs = tp.delta.encode(_t(_np(1, (B,))))
    tmsgs = tp.theta.encode(_t(_np(2, (B,))))
    w = torch.ones(B)
    ref = aggregate_wire(params, theta, g, dmsgs, w, CFG, tp, tmsgs=tmsgs)
    carry = stream_chunk(None, dmsgs, w, tp, tmsgs=tmsgs, exact=True)
    out = finish_stream(params, theta, g, carry, B, CFG)
    for a, b in zip(ref[:3], out[:3]):
        assert _equal(a, b)
    for k in ("drift", "norm_drift", "freshness"):
        assert torch.equal(ref[3][k], out[3][k]), k
    assert _equal(ref[4]["step"], out[4]["step"])


@pytest.mark.parametrize("name", ["dense", "qblock"])
def test_stream_multichunk_close_to_monolithic_and_to_reference(name):
    params, theta, g = _server()
    deltas, thetas = _np(3, (B,)), _np(4, (B,))
    tp = _tp(name)
    cut = 4
    part = lambda t, a, b: tree_map(lambda x: x[a:b], t)  # noqa: E731

    def fold():
        c = stream_chunk(None, tp.delta.encode(_t(part(deltas, 0, cut))),
                         torch.ones(cut), tp,
                         tmsgs=tp.theta.encode(_t(part(thetas, 0, cut))))
        c = stream_chunk(c, tp.delta.encode(_t(part(deltas, cut, B))),
                         torch.ones(B - cut), tp,
                         tmsgs=tp.theta.encode(_t(part(thetas, cut, B))))
        return finish_stream(_t(params), _t(theta), _t(g), c, B, CFG)

    out, again = fold(), fold()
    for a, b in zip(out[:3], again[:3]):
        assert _equal(a, b)
    mono = aggregate_wire(_t(params), _t(theta), _t(g),
                          tp.delta.encode(_t(deltas)), torch.ones(B), CFG,
                          tp, tmsgs=tp.theta.encode(_t(thetas)))
    for a, b in zip(tree_leaves(mono[:3]), tree_leaves(out[:3])):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    assert float(out[3]["drift"]) >= 0.0
    np.testing.assert_allclose(float(out[3]["drift"]),
                               float(mono[3]["drift"]), rtol=1e-4)
    if name != "dense":
        return
    # the reference's stream on the same dense uploads
    jtp = JaxTransport(JaxDense(), JaxDense())
    jw = jnp.ones((B,), jnp.float32)
    enc = lambda t: jax.vmap(jtp.delta.encode)(  # noqa: E731
        jax.tree.map(jnp.asarray, t))
    c = jax_stream(None, enc(part(deltas, 0, cut)), jw[:cut], jtp,
                   tmsgs=enc(part(thetas, 0, cut)))
    c = jax_stream(c, enc(part(deltas, cut, B)), jw[cut:], jtp,
                   tmsgs=enc(part(thetas, cut, B)))
    want = jax_finish(*(jax.tree.map(jnp.asarray, x)
                        for x in (params, theta, g)), c, B,
                      JaxAggCfg(lr=0.05, local_steps=4))
    for a, b in zip(jax.tree.leaves(want[:3]), tree_leaves(out[:3])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(out[3]["drift"]),
                               float(want[3]["drift"]), rtol=1e-4)


def test_stream_chunk_rejects_bad_calls():
    tp = _tp("dense")
    dmsgs = tp.delta.encode(_t(_np(1, (B,))))
    w = torch.ones(B)
    carry = stream_chunk(None, dmsgs, w, tp)
    with pytest.raises(ValueError, match="single-chunk"):
        stream_chunk(carry, dmsgs, w, tp, exact=True)
    with pytest.raises(ValueError, match="not both"):
        stream_chunk(None, dmsgs, w, tp, tmsgs=dmsgs,
                     thetas=_t(_np(2, (B,))))


def test_dequant_accumulate_carry_is_carry_plus_sum_bitwise():
    """The carry operand's plain path, and QBlock.accumulate's fold."""
    gen = torch.Generator().manual_seed(5)
    ns = (1000, 128, 10, 384)
    coded = [quantize(torch.randn((4, n), generator=gen)) for n in ns]
    w = torch.rand(4, generator=gen) * 0.8 + 0.1
    carry = [torch.randn(n, generator=gen) for n in ns]
    carry[2][3] = float("nan")
    qs, ss = [q for q, _ in coded], [s for _, s in coded]
    before = dequant_accumulate.launches
    got = dequant_accumulate_group(qs, ss, w, carry=carry)
    plain = dequant_accumulate_group(qs, ss, w)
    assert dequant_accumulate.launches == before       # CPU: plain path
    for c, g, p in zip(carry, got, plain):
        assert torch.equal(torch.isnan(g), torch.isnan(c + p))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(c + p))
    assert bool(torch.isnan(got[2][3]))
    assert all(torch.equal(a, b) for a, b in zip(
        plain, dequant_accumulate_group_plain(qs, ss, w)))
    tp = _tp("qblock")
    msgs = tp.delta.encode(_t(_np(6, (4,))))
    base = tp.delta.accumulate(msgs, w)
    run = tp.delta.accumulate(msgs, w)
    folded = tp.delta.accumulate(msgs, w, carry=run)
    assert _equal(folded, tree_map(lambda a, b: a + b, run, base))
    with pytest.raises(ValueError, match="carry per q"):
        dequant_accumulate_group(qs, ss, w, carry=carry[:1])
    with pytest.raises(ValueError, match="float32"):
        dequant_accumulate_group(qs[:1], ss[:1], w,
                                 carry=[carry[0].double()])


# ---------------------------------------------------- experiment fixture

@pytest.fixture(scope="module")
def problem():
    X, y = make_image_classification(400, image_size=8, n_classes=4,
                                     seed=0, noise=1.0)
    parts = stream_dirichlet_map(y, POP, alpha=0.3, samples_per_client=32,
                                 seed=0)
    jparams = jax_init_cnn(jax.random.key(0), n_classes=4, width=4, blocks=1)

    @mark_thread_safe
    def batch_fn(cid, rng):
        idx = rng.choice(parts[cid], size=4)
        return {"x": X[idx], "y": y[idx]}

    return dict(jparams=jparams, batch_fn=batch_fn)


def _run(problem, algo="scaffold", rounds=3, budget=None, tmp_path=None,
         **kw):
    params = params_from_numpy(jax.tree.map(np.asarray, problem["jparams"]),
                               "cpu")
    exp = build_experiment(
        algo, params=params,
        loss_fn=lambda p, b: classification_loss(cnn_apply(p, b["x"]),
                                                 b["y"]),
        client_batch_fn=problem["batch_fn"], rounds=rounds, local_steps=2,
        population_size=POP, cohort_size=8, state_budget=budget, seed=0,
        spill_dir=None if tmp_path is None else str(tmp_path),
        device="cpu", **kw)
    return exp, exp.run()


def _assert_bitwise(exp_a, h_a, exp_b, h_b, keys=("loss", "drift",
                                                 "upload_bytes")):
    for ra, rb in zip(h_a, h_b):
        for k in keys:
            if k in ra or k in rb:
                assert ra[k] == rb[k], (k, ra[k], rb[k])
    assert _equal(exp_a.server.params, exp_b.server.params)


# ------------------------------------------------- single-chunk parity

@pytest.mark.parametrize("algo,kw", [
    ("scaffold", {}), ("fedavg", {}),
    ("fedpac_soap", dict(opt_kwargs={"eps": 1e-3})),
    ("fedpac_sophia", dict(lr=2e-2, delta_codec="qblock",
                           theta_codec="qblock")),
])
def test_single_chunk_pipelined_bitwise_equals_serial(problem, algo, kw):
    e0, h0 = _run(problem, algo=algo, rounds=2, **kw)
    e1, h1 = _run(problem, algo=algo, rounds=2, pipeline=True,
                  pipeline_chunk=64, **kw)
    assert e1.pipeline is not None and e1.pipeline.exact
    assert h1[-1]["pipeline_chunks"] == 1
    _assert_bitwise(e0, h0, e1, h1, keys=("loss", "drift", "norm_drift",
                                          "beta", "upload_bytes"))
    assert _equal(e0.server.theta, e1.server.theta)


# ------------------------------------------- multi-chunk determinism

def test_multichunk_worker_count_invariant_and_close_to_serial(problem):
    runs = {w: _run(problem, algo="fedpac_sophia", pipeline=True,
                    pipeline_chunk=3, pipeline_workers=w, lr=2e-2,
                    delta_codec="qblock", theta_codec="qblock")
            for w in (1, 8)}
    e1, h1 = runs[1]
    assert h1[-1]["pipeline_chunks"] == 3
    assert h1[-1]["pipeline_chunk_size"] == 3
    assert 0.0 <= h1[-1]["pipeline_bubble"] <= 1.0
    _assert_bitwise(e1, h1, *runs[8])
    e0, h0 = _run(problem, algo="fedpac_sophia", lr=2e-2,
                  delta_codec="qblock", theta_codec="qblock")
    for ra, rb in zip(h0, h1):
        np.testing.assert_allclose(rb["loss"], ra["loss"], rtol=1e-5)
        assert ra["upload_bytes"] == rb["upload_bytes"]
    for a, b in zip(tree_leaves(e0.server.params),
                    tree_leaves(e1.server.params)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


def test_multichunk_pipeline_matches_reference(problem, tmp_path):
    """scaffold (no device randomness) through both packages' pipelines."""
    jexp = jax_build(
        "scaffold", params=problem["jparams"],
        loss_fn=lambda p, b: jax_loss(jax_cnn(p, b["x"]), b["y"]),
        client_batch_fn=problem["batch_fn"], rounds=3, local_steps=2,
        population_size=POP, cohort_size=8, state_budget=8, seed=0,
        spill_dir=str(tmp_path / "j"), pipeline=True, pipeline_chunk=3)
    want = jexp.run()
    exp, got = _run(problem, budget=8, tmp_path=tmp_path / "t",
                    pipeline=True, pipeline_chunk=3)
    for w, g in zip(want, got):
        for k in ("upload_bytes", "pipeline_chunks", "state_spills",
                  "state_restores", "state_peak"):
            assert w[k] == g[k], k
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jexp.server.params),
                    tree_leaves(exp.server.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)


def test_pipelined_spill_restore_bitwise(problem, tmp_path):
    """budget = cohort spills every round: the deferred acquire, prefetch
    and collect_pending reproduce the serial store path exactly."""
    kw = dict(rounds=4, budget=8, delta_codec="qblock")
    e0, h0 = _run(problem, tmp_path=tmp_path / "s", **kw)
    e1, h1 = _run(problem, tmp_path=tmp_path / "p", pipeline=True,
                  pipeline_chunk=8, **kw)
    assert h1[-1]["state_spills"] > 0 and h1[-1]["state_restores"] > 0
    for k in ("state_spills", "state_restores", "state_peak"):
        assert h1[-1][k] == h0[-1][k]
    _assert_bitwise(e0, h0, e1, h1)
    a = _run(problem, tmp_path=tmp_path / "a", pipeline=True,
             pipeline_chunk=3, pipeline_workers=1, **kw)
    b = _run(problem, tmp_path=tmp_path / "b", pipeline=True,
             pipeline_chunk=3, pipeline_workers=8, **kw)
    assert a[1][-1]["state_restores"] > 0
    _assert_bitwise(a[0], a[1], b[0], b[1])


def test_pipeline_writes_a_round_owned_state(problem):
    """Chunk 1 clones the store's state and later chunks update the clone
    in place: the tensors the experiment held before a round are not
    written by it (restored rows aside, which land in freshly assigned
    slots: here zero rows into zero rows)."""
    params = params_from_numpy(jax.tree.map(np.asarray, problem["jparams"]),
                               "cpu")
    exp = build_experiment(
        "scaffold", params=params,
        loss_fn=lambda p, b: classification_loss(cnn_apply(p, b["x"]),
                                                 b["y"]),
        client_batch_fn=problem["batch_fn"], rounds=2, local_steps=2,
        population_size=POP, cohort_size=8, seed=0, pipeline=True,
        pipeline_chunk=3, device="cpu")
    live_params, live_state = exp.server.params, exp.state_store.state
    snap_p = tree_map(lambda x: x.clone(), live_params)
    snap_c = tree_map(lambda x: x.clone(), live_state.c_clients)
    exp.run_round()
    exp.run_round()
    assert exp.state_store.state is not live_state
    assert _equal(live_params, snap_p)
    assert _equal(live_state.c_clients, snap_c)
    assert not _equal(exp.state_store.state.c_clients, snap_c)


# ------------------------------------------------- validation, fallback

def test_pipeline_config_validation():
    with pytest.raises(ValueError, match="population"):
        FedConfig(pipeline=True, n_clients=4, device="cpu")
    with pytest.raises(ValueError, match="sync"):
        FedConfig(pipeline=True, population_size=100, cohort_size=4,
                  runtime="async", device="cpu")
    with pytest.raises(ValueError, match="pipeline_chunk"):
        FedConfig(pipeline_chunk=0, device="cpu")
    with pytest.raises(ValueError, match="pipeline_workers"):
        FedConfig(pipeline_workers=0, device="cpu")


def test_mixing_algorithms_fall_back_to_serial_round(problem):
    with pytest.warns(RuntimeWarning, match="mixing"):
        exp, _ = _run(problem, algo="fedpm_adamw", rounds=0, pipeline=True)
    assert exp.pipeline is None
    rec = exp.run_round()          # the serial round still works
    assert np.isfinite(rec["loss"])


# ------------------------------------------------------ observability

def test_pipeline_emits_chunk_spans(problem):
    exp, _ = _run(problem, rounds=0, pipeline=True, pipeline_chunk=4)
    sink = MemorySink()
    attach(exp, sink)
    exp.run(rounds=1)
    for ev in sink.events:
        validate_event(ev)
    spans = [e for e in sink.events if e["event"] == "span"]
    assert {"staging", "state_acquire", "chunk_stage", "chunk_restore",
            "chunk_compute", "flush"} <= {e["phase"] for e in spans}
    assert sorted(e["chunk"] for e in spans
                  if e["phase"] == "chunk_compute") == [0, 1]
    assert all(e["dur_s"] >= 0 for e in spans)
    rec = exp.history[-1]
    assert rec["pipeline_stage_wait_s"] >= 0
    assert rec["pipeline_restore_wait_s"] >= 0


def test_serial_population_round_emits_staging_subspans(problem):
    exp, _ = _run(problem, rounds=0)
    sink = MemorySink()
    attach(exp, sink)
    exp.run(rounds=1)
    phases = {e["phase"] for e in sink.events if e["event"] == "span"}
    assert {"staging", "stage_batches", "state_acquire", "update"} <= phases


# -------------------------------------------------------- host buffers

def test_staging_buffers_reuse_peek_and_copy():
    bufs = StagingBuffers()
    row = {"x": np.ones((2, 3), np.float32)}
    a = bufs.get(("pipe", 0), 4, row)
    assert bufs.get(("pipe", 0), 4, row)["x"] is a["x"]   # reused
    assert bufs.get(("pipe", 1), 4, row)["x"] is not a["x"]
    StagingBuffers.fill_row(a, 2, row)
    peeked = bufs.peek(("pipe", 0), 4)
    assert peeked["x"] is a["x"]
    np.testing.assert_array_equal(peeked["x"][2].numpy(), row["x"])
    out = bufs.to_device(("pipe", 0), 4, "cpu")
    assert torch.equal(out["x"], a["x"])
    StagingBuffers.fill_row(a, 2, {"x": np.zeros((2, 3), np.float32)})
    np.testing.assert_array_equal(out["x"][2].numpy(), row["x"])  # a copy
    with pytest.raises(KeyError):
        bufs.peek(("pipe", 9), 4)


def test_thread_safety_contract(problem):
    def unsafe(cid, rng):
        return cid

    @mark_thread_safe
    def safe(cid, rng):
        return cid

    assert not is_thread_safe(unsafe) and is_thread_safe(safe)
    assert serialized_unless_thread_safe(safe) is safe
    wrapped = serialized_unless_thread_safe(unsafe)
    assert wrapped is not unsafe and wrapped(3, None) == 3
    # an unmarked batch fn is serialized by the stager, to the same values
    marked = problem["batch_fn"]
    kw = dict(rounds=1, pipeline=True, pipeline_chunk=3, pipeline_workers=4)
    e0, h0 = _run(problem, **kw)
    problem = dict(problem, batch_fn=lambda cid, rng: marked(cid, rng))
    assert not is_thread_safe(problem["batch_fn"])
    e1, h1 = _run(problem, **kw)
    _assert_bitwise(e0, h0, e1, h1)
