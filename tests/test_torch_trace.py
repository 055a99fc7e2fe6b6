"""The port's tracing: span stamps on the profiler's clock and their
nesting, the live tracer (``obs.trace.current``), the counters where the
work happens (``obs.counters``) and their differences in the ``round``
event, and the layer spans nested inside the sync round, the async
dispatch and flush, and the pipelined round.  Port only: the JAX package
has no nested spans and no counters (the parity of the top-level events
is in tests/test_torch_obs.py, test_torch_async.py and
test_torch_traffic.py).  The problems are the one-block CNN on 8x8
images, K=2, on the CPU.
"""
import dataclasses
import threading
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.api import (
    AsyncConfig, LatencyModel, build_experiment, resolve_scenario,
)
from repro_torch.data import make_image_classification, stream_dirichlet_map
from repro_torch.fed.staging import mark_thread_safe
from repro_torch.models.vision import classification_loss, cnn_apply, init_cnn
from repro_torch.obs import MemorySink, Tracer, attach, counters
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs import trace as obs_trace
from repro_torch.obs import validate_event

def _tiny_cnn():
    spec = resolve_scenario("cifar_like_cnn")
    return dataclasses.replace(
        spec, source_kwargs=dict(spec.source_kwargs, n=600, image_size=8),
        model_kwargs={"width": 8, "blocks": 1})


def _spans(sink):
    return [e for e in sink.events if e["event"] == "span"]


def _by_id(spans):
    return {e["id"]: e for e in spans}


def _assert_nested(spans):
    """Every parent exists, encloses its child's stamps, and lends it its
    round where the child has none of its own."""
    ids = _by_id(spans)
    assert len(ids) == len(spans)
    for e in spans:
        validate_event(e)
        if "parent" in e:
            p = ids[e["parent"]]
            assert p["t0_ns"] <= e["t0_ns"] <= e["t1_ns"] <= p["t1_ns"]
            assert e.get("round") == p.get("round")


# ---------------------------------------------------------------- tracer

def test_span_stamps_ids_parents_and_rounds():
    sink = MemorySink()
    tr = Tracer(sinks=(sink,))
    before = time.time_ns()
    with tr.span("update", round=4):
        with tr.span("local_update"):
            with tr.span("encode"):
                pass
        with tr.span("aggregate", round=9):
            pass
    with tr.span("eval"):
        pass
    after = time.time_ns()
    s = {e["phase"]: e for e in _spans(sink)}
    assert [e["phase"] for e in _spans(sink)] == [
        "encode", "local_update", "aggregate", "update", "eval"]
    assert "parent" not in s["update"] and "parent" not in s["eval"]
    assert s["local_update"]["parent"] == s["update"]["id"]
    assert s["encode"]["parent"] == s["local_update"]["id"]
    assert s["aggregate"]["parent"] == s["update"]["id"]
    assert (s["encode"]["round"], s["local_update"]["round"],
            s["aggregate"]["round"]) == (4, 4, 9)
    assert "round" not in s["eval"]
    assert sorted(e["id"] for e in s.values()) == list(range(5))
    for e in s.values():
        validate_event(e)
        assert before <= e["t0_ns"] <= e["t1_ns"] <= after
        assert abs((e["t1_ns"] - e["t0_ns"]) * 1e-9 - e["dur_s"]) < 1e-3
    assert s["update"]["t0_ns"] <= s["local_update"]["t0_ns"]
    assert s["aggregate"]["t1_ns"] <= s["update"]["t1_ns"]
    assert s["update"]["t1_ns"] <= s["eval"]["t0_ns"]


def test_span_stamps_fall_inside_a_profiler_range():
    """The stamps are on the clock ``torch.profiler`` stamps its events
    with: a span inside a ``record_function`` range lies inside that
    range's interval in the trace, to within 1 ms."""
    sink = MemorySink()
    tr = Tracer(sinks=(sink,))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with record_function("region"):
            with tr.span("update"):
                torch.ones(64, 64) @ torch.ones(64, 64)
                time.sleep(0.005)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "region"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    (span,) = _spans(sink)
    assert start - 10**6 <= span["t0_ns"] <= span["t1_ns"] <= end + 10**6
    assert span["t1_ns"] - span["t0_ns"] >= 5 * 10**6


def test_disabled_tracer_reads_no_clock_and_takes_no_snapshot(monkeypatch):
    def forbidden(*args):
        raise AssertionError("a disabled tracer read a clock or counters")

    tr = Tracer(clock=forbidden)
    monkeypatch.setattr(obs_trace, "time", types.SimpleNamespace(
        time_ns=forbidden, perf_counter=forbidden))
    monkeypatch.setattr(obs_trace.counters, "snapshot", forbidden)
    with tr.activate():
        assert obs_trace.current() is tr
        with tr.span("update", round=1):
            with obs_trace.current().span("telemetry"):
                pass
    tr.round_event(1, {"loss": 1.0})
    assert (tr.spans, tr.rounds, tr.seq) == (2, 1, 0)


def test_current_is_the_activated_tracer_and_null_elsewhere():
    assert obs_trace.current() is obs_trace.NULL_TRACER
    a, b = Tracer(), Tracer()
    seen = []
    with a.activate():
        assert obs_trace.current() is a
        with b.activate():
            assert obs_trace.current() is b
        assert obs_trace.current() is a
        # a new thread starts from the default context
        th = threading.Thread(target=lambda: seen.append(obs_trace.current()))
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    assert obs_trace.current() is obs_trace.NULL_TRACER
    assert seen == [obs_trace.NULL_TRACER]


@pytest.mark.parametrize("bad", [
    {"t0_ns": 5, "t1_ns": 4},
    {"t0_ns": 1.5, "t1_ns": 4},
    {"t0_ns": 1, "t1_ns": 4, "id": "3"},
    {"t0_ns": 1, "t1_ns": 4, "id": 3, "parent": 2.0},
])
def test_validate_event_checks_the_stamps(bad):
    ev = {"event": "span", "run_id": "r", "seq": 0, "phase": "update",
          "dur_s": 0.1}
    validate_event(dict(ev, t0_ns=1, t1_ns=1, id=0, parent=3))
    validate_event(ev)                # stamps stay optional
    with pytest.raises(ValueError):
        validate_event(dict(ev, **bad))


def test_restored_tracer_continues_span_ids():
    sink = MemorySink()
    tr = Tracer(sinks=(sink,))
    for _ in range(3):
        with tr.span("update"):
            pass
    resumed = Tracer.from_state(tr.state(), sinks=(sink,))
    with resumed.span("update"):
        pass
    assert [e["id"] for e in _spans(sink)] == [0, 1, 2, 3]


# -------------------------------------------------------------- counters

def test_round_event_carries_counter_differences(monkeypatch):
    monkeypatch.setattr(counters, "_last_traced_round", None)
    sink = MemorySink()
    tr = Tracer(sinks=(sink,))
    with tr.activate():
        counters.add("omega.h2d_bytes", 4096)
        counters.add("omega.draw_s", 0.25)
        tr.round_event(1, {"loss": 1.0})
    with tr.activate():
        counters.add("omega.h2d_bytes", 8)
        tr.round_event(2, {"loss": 0.5})
    first, second = sink.rounds()
    assert first["counters"]["omega.h2d_bytes"] == 4096
    assert first["counters"]["omega.draw_s"] == pytest.approx(0.25)
    assert second["counters"]["omega.h2d_bytes"] == 8
    assert second["counters"]["omega.draw_s"] == 0.0
    assert counters.last_traced_round() == second["counters"]
    # a round event outside any activated block carries no counters
    tr.round_event(3, {"loss": 0.1})
    assert "counters" not in sink.rounds()[-1]
    assert counters.last_traced_round() == second["counters"]


def test_snapshot_reads_the_launch_counters_of_loaded_kernels():
    from repro_torch.kernels.soap_rotate.kernel import adam_moments
    snap = counters.snapshot()
    assert snap["launches.adam_moments"] == adam_moments.launches
    assert all(isinstance(v, (int, float)) for v in snap.values())
    adam_moments.launches += 3
    try:
        d = counters.delta(snap, counters.snapshot())
    finally:
        adam_moments.launches -= 3
    assert d["launches.adam_moments"] == 3
    assert d["omega.h2d_bytes"] == 0
    assert counters.delta({}, {"launches.quantize": 7}) == {
        "launches.quantize": 7}


def test_omega_h2d_bytes_count_the_copies_not_kept(monkeypatch):
    """Within ``DEVICE_OMEGA_BYTES`` a projection is kept and copied once,
    uncounted; past it every use copies again and counts its host
    bytes (the meta device stands in for a card)."""
    monkeypatch.setattr(obs_telemetry, "_on_device", {})
    monkeypatch.setattr(obs_telemetry, "DEVICE_OMEGA_BYTES", 40 * 8 * 4)
    before = counters.snapshot()["omega.h2d_bytes"]
    obs_telemetry.sketch_omega(5, 40, 8, "meta")
    obs_telemetry.sketch_omega(5, 40, 8, "meta")
    assert counters.snapshot()["omega.h2d_bytes"] == before
    for _ in range(3):
        obs_telemetry.sketch_omega(6, 40, 8, "meta")
    assert counters.snapshot()["omega.h2d_bytes"] == before + 3 * 40 * 8 * 4
    obs_telemetry.sketch_omega(6, 40, 8, "cpu")     # the host's own copy
    assert counters.snapshot()["omega.h2d_bytes"] == before + 3 * 40 * 8 * 4


def test_omega_draw_seconds_count_cache_misses_only():
    # a leaf index and width no model of the tests has: a fresh draw
    before = counters.snapshot()["omega.draw_s"]
    obs_telemetry.sketch_omega(7919, 4099, 8, "cpu")
    drawn = counters.snapshot()["omega.draw_s"]
    assert drawn > before
    obs_telemetry.sketch_omega(7919, 4099, 8, "cpu")      # cached
    assert counters.snapshot()["omega.draw_s"] == drawn


# ------------------------------------------------------- runtimes' spans

@pytest.mark.parametrize("algo,refresh", [("fedpac_soap", True),
                                          ("fedpac_muon", False)])
def test_sync_round_nests_the_layer_spans(algo, refresh):
    exp = build_experiment(algo, scenario=_tiny_cnn(), rounds=2,
                           local_steps=2, device="cpu")
    sink = MemorySink()
    attach(exp, sink)
    exp.run()
    spans = _spans(sink)
    _assert_nested(spans)
    ids = _by_id(spans)
    top = [(e["phase"], e["round"]) for e in spans if "parent" not in e]
    assert top == [(p, r) for r in (1, 2) for p in ("staging", "update",
                                                    "eval")]
    phases = {e["phase"] for e in spans}
    assert ("soap_refresh" in phases) == refresh
    for e in spans:
        parent = ids[e["parent"]]["phase"] if "parent" in e else None
        want = {"local_update": "update", "aggregate": "update",
                "telemetry": "update", "encode": "local_update",
                "soap_refresh": "local_update"}.get(e["phase"])
        assert parent == want, e
    per_round = 8 if refresh else 7
    assert exp.tracer.spans == 2 * per_round
    rounds = sink.rounds()
    assert [r["round"] for r in rounds] == [1, 2]
    assert all("omega.draw_s" in r["counters"] for r in rounds)
    assert counters.last_traced_round() == rounds[-1]["counters"]


def test_async_dispatch_and_flush_nest_the_layer_spans():
    exp = build_experiment(
        "fedpac_soap", scenario=_tiny_cnn(), rounds=2, local_steps=2,
        participation=1.0, device="cpu",
        async_cfg=AsyncConfig(buffer_size=2, concurrency=3,
                              latency=LatencyModel(heterogeneity=1.0)))
    sink = MemorySink()
    attach(exp, sink)
    exp.run()
    spans = _spans(sink)
    _assert_nested(spans)
    ids = _by_id(spans)
    for e in spans:
        if "parent" not in e:
            assert e["phase"] in ("staging", "local_update", "flush",
                                  "eval"), e
            continue
        parent = ids[e["parent"]]
        want = {"encode": "local_update", "soap_refresh": "local_update",
                "aggregate": "flush", "telemetry": "flush"}[e["phase"]]
        assert parent["phase"] == want
        if want == "flush":
            assert e["round"] == parent["round"]
    dispatches = sum(e["phase"] == "local_update" for e in spans)
    assert sum(e["phase"] == "encode" for e in spans) == dispatches
    assert sum(e["phase"] == "aggregate" for e in spans) == 2
    assert sum(e["phase"] == "telemetry" for e in spans) == 2
    assert all("counters" in r for r in sink.rounds())


def test_pipelined_round_nests_the_chunk_layers():
    X, y = make_image_classification(300, image_size=8, n_classes=4,
                                     seed=0, noise=1.0)
    parts = stream_dirichlet_map(y, 64, alpha=0.3, samples_per_client=16,
                                 seed=0)

    @mark_thread_safe
    def batch_fn(cid, rng):
        idx = rng.choice(parts[cid], size=4)
        return {"x": X[idx], "y": y[idx]}

    params = init_cnn(torch.Generator().manual_seed(0), n_classes=4,
                      width=4, blocks=1, device="cpu")
    exp = build_experiment(
        "fedpac_soap", params=params,
        loss_fn=lambda p, b: classification_loss(cnn_apply(p, b["x"]),
                                                 b["y"]),
        client_batch_fn=batch_fn, rounds=1, local_steps=2,
        population_size=64, cohort_size=8, pipeline=True, pipeline_chunk=4,
        seed=0, device="cpu")
    sink = MemorySink()
    attach(exp, sink)
    exp.run()
    spans = _spans(sink)
    _assert_nested(spans)
    ids = _by_id(spans)
    chunks = {e["id"]: e["chunk"] for e in spans
              if e["phase"] == "chunk_compute"}
    assert sorted(chunks.values()) == [0, 1]
    for phase in ("encode", "soap_refresh"):
        inner = [e for e in spans if e["phase"] == phase]
        assert sorted(chunks[e["parent"]] for e in inner) == [0, 1], phase
        assert all(e["round"] == 1 for e in inner)
    acquire = next(e for e in spans if e["phase"] == "state_acquire")
    assert ids[acquire["parent"]]["phase"] == "staging"
    (rnd,) = sink.rounds()
    assert rnd["counters"]["omega.h2d_bytes"] == 0
