"""The port's observability layer against the JAX package: ``collect``,
``client_geom_dist`` and ``staleness_histogram`` on the same inputs (the
reference's JL Omega put into ``obs.telemetry.sketch_omega``), the sync
round's telemetry and trace stream on a small CNN, the Fig. 3 drift
views, the tracer and its schema, the sinks, the BENCH document format
and ``profile_kernels``' envelopes.  The round problem is
``cifar_like_cnn`` cut to 600 8x8 images and one CNN block, K=2, 2
rounds, with the JAX-initialised params carried in.

Tolerances:
  * ``collect`` and its parts: 1e-6 relative (the same f32 reductions in
    other orders); the staleness histogram exact.
  * ``drift_per_layer`` and ``spectral_drift``: 1e-5 relative (LAPACK's
    SVD in each package).
  * the sync round (SOAP, eps=1e-3): SOAP's round tolerances
    (tests/test_torch_round.py): loss 5e-3, test_loss 2e-2, test_acc
    6/768 absolute; drift, norm_drift and each client's sketched
    geometry distance 5% relative; beta, freshness and the staleness
    histogram exact.  The trace's event types, phases and rounds exact.
  * sinks: byte-equal output; BENCH validation: the same accept/reject.
  * ``profile_kernels``: the reference's FLOP and byte counts exactly.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_experiment as jax_build
from repro.core.drift import (
    drift_per_layer as jax_drift_per_layer,
    spectral_drift as jax_spectral_drift,
)
from repro.core.engine import (
    make_controller as jax_controller,
    update_controller as jax_update_controller,
)
from repro.obs import (
    CsvSink as JaxCsvSink, MemorySink as JaxMemorySink,
    StdoutRoundSink as JaxStdoutSink, attach as jax_attach,
    make_bench as jax_make_bench, validate_bench as jax_validate_bench,
)
from repro.obs import telemetry as jax_telemetry
from repro.obs.profiling import _cases as jax_profile_cases
from repro.obs.trace import validate_event as jax_validate_event
from repro.scenarios import resolve as jax_resolve_scenario
from repro_torch.api import build_experiment, materialize, resolve_scenario
from repro_torch.convert import params_from_numpy
from repro_torch.core.drift import drift_per_layer, spectral_drift
from repro_torch.core.engine import make_controller, update_controller
from repro_torch.obs import (
    CsvSink, JsonlSink, MemorySink, STALENESS_BINS, StdoutRoundSink, Tracer,
    attach, client_geom_dist, collect, make_bench, profile_kernels,
    read_bench, staleness_histogram, telemetry_dict, validate_bench,
    validate_event, validate_jsonl, write_bench,
)
from repro_torch.obs import telemetry as obs_telemetry

K = 2
ROUNDS = 2
EPS = 1e-3
TOL = {"loss": 5e-3, "test_loss": 2e-2, "test_acc": 6 / 768}
REL_TOL = {"drift": 0.05, "norm_drift": 0.05}


def _tiny(spec):
    """cifar_like_cnn cut to 600 8x8 images and one CNN block (either
    package's spec)."""
    return dataclasses.replace(
        spec, source_kwargs=dict(spec.source_kwargs, n=600, image_size=8),
        model_kwargs={"width": 8, "blocks": 1})


def _jax_omega(index, width, rank, device):
    """The reference's projection of leaf ``index``, as a port tensor."""
    omega = jax.random.normal(
        jax.random.key(jax_telemetry._SKETCH_KEY + index), (width, rank),
        jnp.float32) / jnp.sqrt(jnp.float32(rank))
    return torch.from_numpy(np.asarray(omega)).to(device)


@pytest.fixture
def reference_omega(monkeypatch):
    monkeypatch.setattr(obs_telemetry, "sketch_omega", _jax_omega)


def _close(got, want, rel=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel,
                               atol=atol)


# ------------------------------------------------------------- telemetry

def _inputs(s, seed):
    r = np.random.default_rng(seed)

    def f(*shape):
        return r.standard_normal(shape).astype(np.float32)

    deltas = {"a": f(s, 6, 5), "b": [f(s, 3)]}
    thetas = {"LR": {"a": {"L": f(s, 6, 6), "R": f(s, 5, 5)}, "b": None},
              "h": f(s, 4)}
    g = {"a": f(6, 5), "b": [f(3)]}
    w = np.abs(f(s)) + 0.2
    return deltas, thetas, g, w


@pytest.mark.parametrize("beta", [0.5, "auto"])
@pytest.mark.parametrize("staleness", [None, [0, 2, 1, 9]])
def test_collect_matches_reference(reference_omega, beta, staleness):
    s = 4
    deltas, thetas, g, w = _inputs(s, 3)
    agg = {"drift": 0.7, "norm_drift": 1.9, "freshness": float(w.mean())}
    jc = jax_controller(beta)
    jn = jax_update_controller(jc, jnp.float32(agg["norm_drift"]),
                               agg["freshness"])
    want = jax_telemetry.collect(
        deltas=deltas, thetas=thetas, weights=jnp.asarray(w), g_global=g,
        ctrl=jc, new_ctrl=jn,
        agg_metrics={k: jnp.float32(v) for k, v in agg.items()},
        staleness=None if staleness is None else jnp.asarray(staleness))
    tc = make_controller(beta, device="cpu")
    tn = update_controller(tc, torch.tensor(agg["norm_drift"]),
                           agg["freshness"])
    t = params_from_numpy
    got = collect(
        deltas=t(deltas, "cpu"), thetas=t(thetas, "cpu"),
        weights=torch.from_numpy(w), g_global=t(g, "cpu"), ctrl=tc,
        new_ctrl=tn,
        agg_metrics={k: torch.tensor(v, dtype=torch.float32)
                     for k, v in agg.items()},
        staleness=None if staleness is None else torch.tensor(staleness))
    for f in dataclasses.fields(got):
        g_val = getattr(got, f.name)
        w_val = np.asarray(getattr(want, f.name))
        assert tuple(g_val.shape) == w_val.shape, f.name
        if f.name == "staleness_hist":
            assert g_val.dtype == torch.int32
            assert g_val.tolist() == w_val.tolist()
        else:
            _close(g_val, w_val)
    # the step form (the fused flush's reduced mean) gives the same
    step = jax.tree.map(lambda x: np.tensordot(w, x, axes=(0, 0)) / s,
                        deltas)
    got_step = collect(
        step=t(step, "cpu"), thetas=t(thetas, "cpu"),
        weights=torch.from_numpy(w), g_global=t(g, "cpu"), ctrl=tc,
        new_ctrl=tn, agg_metrics={k: torch.tensor(v, dtype=torch.float32)
                                  for k, v in agg.items()})
    _close(got_step.update_corr_cos, want.update_corr_cos, rel=1e-5)
    with pytest.raises(ValueError, match="exactly one"):
        collect(thetas=None, weights=torch.ones(2), g_global=None, ctrl=tc,
                new_ctrl=tn, agg_metrics={})
    d = telemetry_dict(got)
    assert d == json.loads(json.dumps(d))


def test_geom_dist_and_histogram_match_reference(reference_omega):
    _, thetas, _, _ = _inputs(5, 4)
    wide = {"x": np.random.default_rng(1).standard_normal(
        (5, 300)).astype(np.float32)}
    for tree in (thetas, wide):
        want = jax_telemetry.client_geom_dist(tree, 5)
        got = client_geom_dist(params_from_numpy(tree, "cpu"), 5,
                               device="cpu")
        _close(got, want)
    assert client_geom_dist(None, 3, device="cpu").tolist() == [0.0] * 3
    s = [0, 0, 1, 3, 99, -2]
    want = jax_telemetry.staleness_histogram(jnp.asarray(s))
    got = staleness_histogram(torch.tensor(s))
    assert got.dtype == torch.int32 and got.shape == (STALENESS_BINS,)
    assert got.tolist() == np.asarray(want).tolist()


def test_port_omega_is_cached_and_device_shared():
    a = obs_telemetry.sketch_omega(3, 40, 8, "cpu")
    assert obs_telemetry.sketch_omega(3, 40, 8, "cpu") is a
    assert a.shape == (40, 8) and a.dtype == torch.float32
    assert not torch.equal(a, obs_telemetry.sketch_omega(4, 40, 8, "cpu"))
    gen = torch.Generator().manual_seed(obs_telemetry._SKETCH_KEY + 3)
    assert torch.equal(a, torch.randn((40, 8), generator=gen)
                       / float(np.sqrt(8)))


def test_port_omega_copies_on_a_device_are_bounded(monkeypatch):
    """Copies on a device other than the CPU are kept while they fit in
    ``DEVICE_OMEGA_BYTES``; a projection beyond it is copied for each use
    (the meta device stands in for a card)."""
    monkeypatch.setattr(obs_telemetry, "_on_device", {})
    monkeypatch.setattr(obs_telemetry, "DEVICE_OMEGA_BYTES", 40 * 8 * 4)
    a = obs_telemetry.sketch_omega(5, 40, 8, "meta")
    assert a.device.type == "meta" and a.shape == (40, 8)
    assert obs_telemetry.sketch_omega(5, 40, 8, "meta") is a
    b = obs_telemetry.sketch_omega(6, 40, 8, "meta")
    assert b.shape == (40, 8)
    assert obs_telemetry.sketch_omega(6, 40, 8, "meta") is not b
    assert list(obs_telemetry._on_device) == [(5, 40, 8,
                                               torch.device("meta"))]


# ------------------------------------------------------------- drift views

def test_drift_views_match_reference():
    r = np.random.default_rng(5)
    thetas = {"LR": {"w": {"L": r.standard_normal((3, 6, 6)),
                           "R": r.standard_normal((3, 4, 4))},
                     "b": None},
              "v": r.standard_normal((3, 2, 5, 7)), "h": r.standard_normal(
                  (3, 9))}
    thetas = jax.tree.map(lambda x: x.astype(np.float32), thetas)
    tt = params_from_numpy(thetas, "cpu")
    for jfn, tfn in ((jax_drift_per_layer, drift_per_layer),
                     (jax_spectral_drift, spectral_drift)):
        want, got = jfn(thetas), tfn(tt)
        assert list(got) == list(want)
        for k in want:
            _close(got[k], want[k], rel=1e-5)
    assert "h" not in spectral_drift(tt) and "h" in drift_per_layer(tt)


# -------------------------------------------------- sync round and trace

@pytest.fixture(scope="module")
def jax_sync():
    exp = jax_build("fedpac_soap", scenario=_tiny(
        jax_resolve_scenario("cifar_like_cnn")), rounds=ROUNDS,
        local_steps=K, opt_kwargs={"eps": EPS})
    sink = JaxMemorySink()
    jax_attach(exp, sink)
    hist = exp.run()
    return hist, sink.events, jax.tree.map(np.asarray, exp.scenario.params)


def test_sync_round_telemetry_and_trace_match_reference(
        jax_sync, reference_omega):
    want_hist, want_events, jax_params = jax_sync
    scn = materialize(_tiny(resolve_scenario("cifar_like_cnn")), seed=0,
                      n_clients=10, device="cpu")
    scn = dataclasses.replace(scn, params=params_from_numpy(jax_params, "cpu"))
    exp = build_experiment("fedpac_soap", scenario=scn, rounds=ROUNDS,
                           local_steps=K, device="cpu",
                           opt_kwargs={"eps": EPS})
    sink = MemorySink()
    tracer = attach(exp, sink)
    hist = exp.run()
    for ev in sink.events:
        validate_event(ev)
        jax_validate_event(ev)

    def skeleton(events):
        return [(e["event"], e.get("phase"), e.get("round"))
                for e in events]

    assert skeleton(sink.events) == skeleton(want_events)
    assert [e["seq"] for e in sink.events] == list(range(len(sink.events)))
    assert {e["run_id"] for e in sink.events} == {tracer.run_id}
    for w, g in zip([e for e in want_events if e["event"] == "round"],
                    [e for e in sink.events if e["event"] == "round"]):
        for k, t in TOL.items():
            assert abs(g["metrics"][k] - w["metrics"][k]) <= t, k
        wt, gt = w["telemetry"], g["telemetry"]
        assert set(gt) == set(wt)
        for k in ("beta", "beta_next", "freshness", "staleness_hist"):
            assert gt[k] == wt[k], k
        for k in ("drift", "norm_drift"):
            assert gt[k] == pytest.approx(wt[k], rel=REL_TOL[k])
        np.testing.assert_allclose(gt["client_geom_dist"],
                                   wt["client_geom_dist"], rtol=0.05)
        assert sum(gt["staleness_hist"]) == 2 == gt["staleness_hist"][0]
    # round 1 corrects toward g_G = 0; round 2's cosine is defined
    rounds = [e for e in sink.events if e["event"] == "round"]
    assert rounds[0]["telemetry"]["update_corr_cos"] == 0.0
    assert -1.0 <= rounds[1]["telemetry"]["update_corr_cos"] <= 1.0
    assert exp.last_telemetry is not None
    assert [r["loss"] for r in hist] == [e["metrics"]["loss"]
                                          for e in rounds]
    assert (tracer.rounds, tracer.seq) == (ROUNDS, len(sink.events))
    # detached (the default): no events, the counters still advance
    exp.tracer = Tracer()
    exp.run(1)
    assert exp.tracer.rounds == 0 and exp.tracer.spans == 3


def test_log_round_routes_through_the_sink(capsys):
    exp = build_experiment("fedavg", scenario=_tiny(
        resolve_scenario("cifar_like_cnn")), rounds=1, local_steps=1,
        device="cpu")
    rec = exp.run_round()
    capsys.readouterr()
    exp.log_round(rec, 0)
    assert capsys.readouterr().out == \
        f"{ {k: exp.format_metric(v) for k, v in rec.items()} }\n"
    exp.sink = MemorySink()
    exp.log_round(rec, 0)
    assert exp.sink.rounds()[0]["metrics"] is rec
    assert capsys.readouterr().out == ""


# ----------------------------------------------------------- tracer, sinks

def test_tracer_schema_state_and_jsonl(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    t = Tracer(sinks=(JsonlSink(path),))
    t.emit("run_start", runtime="sync")
    with t.span("staging", round=1):
        pass
    t.client_dropped(3, reason="dropout", version=0, sim_time=1.5)
    t.round_event(1, {"loss": torch.tensor(0.5), "n": np.int64(3)},
                  telemetry={"drift": 0.1})
    t.sinks[0].close()
    assert validate_jsonl(path) == 4
    lines = [json.loads(x) for x in open(path)]
    assert [e["seq"] for e in lines] == [0, 1, 2, 3]
    assert lines[3]["metrics"] == {"loss": 0.5, "n": 3}
    restored = Tracer.from_state(t.state(), sinks=(MemorySink(),))
    assert (restored.run_id, restored.seq, restored.rounds) == (
        t.run_id, 4, 1)
    for bad in ({"event": "round", "run_id": "x", "seq": 0},
                {"event": "bogus", "run_id": "x", "seq": 0},
                {"event": "client_dropped", "run_id": "x", "seq": 0,
                 "client_id": 1, "reason": "rage_quit", "version": 0}):
        with pytest.raises(ValueError):
            jax_validate_event(bad)
        with pytest.raises(ValueError):
            validate_event(bad)
    with pytest.raises(ValueError, match="drop reason"):
        t.client_dropped(0, reason="rage_quit", version=0)


def test_stdout_and_csv_sinks_match_reference(capsys, tmp_path):
    rec = {"loss": 0.123456789, "round": 3, "note": None, "vec": [1.0, 2.0],
           "acc": 1 / 3}
    ev = {"event": "round", "run_id": "x", "round": 3, "metrics": rec}
    JaxStdoutSink().emit(ev)
    want = capsys.readouterr().out
    StdoutRoundSink().emit(ev)
    assert capsys.readouterr().out == want
    StdoutRoundSink().emit({"event": "span", "phase": "eval"})
    assert capsys.readouterr().out == ""
    events = [{"event": "round", "round": 1, "metrics": {"loss": 0.5},
               "telemetry": {"drift": 0.1, "staleness_hist": [4, 0]}},
              {"event": "span", "phase": "eval"},
              {"event": "round", "round": 2, "metrics": {"loss": 0.4},
               "telemetry": {"drift": 0.2, "staleness_hist": [4, 0]}}]
    texts = []
    for cls, name in ((JaxCsvSink, "ref.csv"), (CsvSink, "port.csv")):
        with cls(str(tmp_path / name)) as sink:
            for e in events:
                sink.emit(e)
        texts.append((tmp_path / name).read_text())
    assert texts[0] == texts[1]
    assert texts[1].splitlines()[0] == "round,loss,drift"


# --------------------------------------------------------------- BENCH docs

_MUTATIONS = [
    (lambda d: None),
    (lambda d: d.pop("rows")),
    (lambda d: d.update(schema_version=99)),
    (lambda d: d.update(rows=[])),
    (lambda d: d["rows"].append(dict(d["rows"][0]))),
    (lambda d: d["rows"][0].update(us_per_call="fast")),
    (lambda d: d["rows"][0].update(us_per_call=True)),
    (lambda d: d["rows"][0].update(name=3)),
    (lambda d: d["rows"][0]["derived"].update(bad=[1, 2])),
    (lambda d: d["rows"][0].pop("us_per_call")),
]


@pytest.mark.parametrize("mutate", _MUTATIONS)
def test_bench_validation_matches_reference(mutate):
    def verdict(make, validate):
        doc = make("executor", [{"name": "a", "us_per_call": 1.0,
                                 "derived": {"x": 1}}], config={"q": True})
        mutate(doc)
        try:
            validate(doc)
        except ValueError as e:
            return str(e)
        return "ok"

    assert verdict(make_bench, validate_bench) == verdict(jax_make_bench,
                                                          jax_validate_bench)


def test_bench_write_read_roundtrip(tmp_path):
    rows = [{"name": "r", "us_per_call": 12.5, "derived": {"loss": 0.9}}]
    path = str(tmp_path / "BENCH_x.json")
    assert write_bench(path, "x", rows, config={"quick": True}) == \
        read_bench(path)
    assert read_bench(path)["rows"] == rows


# ------------------------------------------------------------- profiling

@pytest.mark.parametrize("shape", [(64, 96), (128, 128)])
def test_profile_kernels_ref_rows_carry_reference_envelopes(shape):
    want = {c[0]: (c[4], c[5]) for c in jax_profile_cases(shape, 128, True)
            if c[1] == "ref"}
    recs = profile_kernels(shapes=(shape,), iters=1, device="cpu")
    assert [r["kernel"] for r in recs] == list(want)
    for r in recs:
        assert r["impl"] == "ref" and r["backend"] == "cpu"
        assert not r["interpret"] and r["shape"] == list(shape)
        assert (r["flops"], r["bytes"]) == want[r["kernel"]]
        assert r["us_per_call"] > 0 and r["gflops_s"] > 0 and r["gbps"] > 0


def test_profile_kernels_rejects_kernel_rows_on_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        profile_kernels(device="cpu", impls=("ref", "kernel"))
    with pytest.raises(ValueError, match="unknown kernels"):
        profile_kernels(device="cpu", kernels=("bogus",))
    with pytest.raises(ValueError, match="unknown impls"):
        profile_kernels(device="cpu", impls=("pallas",))
