"""The port's buffered-asynchronous runtime against the JAX package: the
scheduler and staleness weights (numpy copies: exact), the joining of
one-client wire messages, the zero-staleness flush (bitwise against the
port's own sync round, telemetry included), 3-flush histories of
``fedpac_soap`` and of ``fedpac_sophia`` on the qblock wire with error
feedback and ``max_staleness`` (the discard path), their trace streams,
and ``build_experiment``'s runtime rules.  The problem is ``cifar_like_cnn`` cut to
600 8x8 images and one CNN block, K=2, with the JAX-initialised params
carried in.

Tolerances:
  * scheduler events, staleness weights, the simulated fields of a
    history (sim_time, staleness, max_staleness, dropped, discarded,
    upload bytes) and the trace's event types, phases, rounds, client ids
    and drop reasons: exact.
  * ``fedpac_soap`` histories: SOAP's round tolerances at eps=1e-3
    (tests/test_torch_round.py): loss 5e-3, test_loss 2e-2, test_acc
    6/768 absolute, drift and norm_drift 5% relative.
  * ``fedpac_sophia`` + qblock + EF with the reference's probes injected:
    Sophia's (tests/test_torch_sophia.py): loss and test_loss 1e-4,
    test_acc 2/768, drift and norm_drift 1e-3 relative.
  * the zero-staleness flush against the sync round: bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_experiment as jax_build
from repro.fed.async_runtime import (
    AsyncConfig as JaxAsyncConfig, LatencyModel as JaxLatency,
    SimScheduler as JaxScheduler,
    make_staleness_weight as jax_staleness_weight,
)
from repro.fed.staging import stage_client_batches as jax_stage_client
from repro.scenarios import resolve as jax_resolve_scenario
from repro_torch.api import (
    AsyncConfig, AsyncFederatedExperiment, LatencyModel, TrafficConfig,
    TrafficExperiment, build_experiment, materialize, resolve_scenario,
)
from repro_torch.convert import params_from_numpy
from repro_torch.core import init_server
from repro_torch.core import transport as T
from repro_torch.core.algorithms import (
    build_round_fn, make_local_update, make_wire_client_step, resolve,
    round_client_state_spec, zero_theta,
)
from repro_torch.core.client import LocalRunConfig
from repro_torch.core.engine import make_cohort_executor, make_controller
from repro_torch.fed import FedConfig, make_experiment
from repro_torch.fed.async_runtime import (
    SimScheduler, make_async_aggregate_fn, make_staleness_weight,
)
from repro_torch.fed.staging import stage_client_batches
from repro_torch.obs import MemorySink, attach, validate_event
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_leaves, tree_map, tree_map_with_path,
)

K = 2
FLUSHES = 3
SOAP_TOL = {"loss": 5e-3, "test_loss": 2e-2, "test_acc": 6 / 768}
SOAP_REL_TOL = {"drift": 0.05, "norm_drift": 0.05}
SOPHIA_TOL = {"loss": 1e-4, "test_loss": 1e-4, "test_acc": 2 / 768}
SOPHIA_REL_TOL = {"drift": 1e-3, "norm_drift": 1e-3}
EXACT = ("sim_time", "staleness", "max_staleness", "dropped", "discarded",
         "upload_bytes", "upload_total_bytes", "cohort_size", "round",
         "freshness")
QBLOCK = dict(delta_codec="qblock", theta_codec="qblock")
RUNS = {
    "fedpac_soap": dict(
        algo="fedpac_soap", kw=dict(opt_kwargs={"eps": 1e-3}),
        acfg=dict(buffer_size=2, concurrency=4,
                  latency=dict(heterogeneity=1.0, jitter=0.5, dropout=0.3))),
    "fedpac_sophia_qblock_ef": dict(
        algo="fedpac_sophia", kw=dict(lr=2e-2, **QBLOCK),
        acfg=dict(buffer_size=2, concurrency=5, max_staleness=1,
                  latency=dict(heterogeneity=1.5, jitter=0.5))),
}


def _tiny(spec):
    """cifar_like_cnn cut to 600 8x8 images and one CNN block (either
    package's spec)."""
    return dataclasses.replace(
        spec, source_kwargs=dict(spec.source_kwargs, n=600, image_size=8),
        model_kwargs={"width": 8, "blocks": 1})


def _mismatches(want_hist, got_hist, tol, rel_tol):
    bad = []
    for r, (w, g) in enumerate(zip(want_hist, got_hist)):
        for k in EXACT:
            if w[k] != g[k]:
                bad.append((r, k, w[k], g[k]))
        for k, t in tol.items():
            if abs(w[k] - g[k]) > t:
                bad.append((r, k, w[k], g[k]))
        for k, t in rel_tol.items():
            if abs(w[k] - g[k]) > t * abs(w[k]):
                bad.append((r, k, w[k], g[k]))
    return bad


def _skeleton(events):
    """What a trace must repeat exactly: event types, phases, rounds,
    client ids, drop reasons and versions (run_id, seq, dur_s and float
    metrics excluded), of the top-level events: the spans the port nests
    in a dispatch or a flush are its own."""
    keys = ("event", "phase", "round", "client_id", "reason", "version",
            "sim_time")
    return [tuple(e.get(k) for k in keys) for e in events
            if "parent" not in e]


# ------------------------------------------------------------- scheduler

def _trace(mod_scheduler, mod_latency, seed, versions=25):
    lat = mod_latency(heterogeneity=1.0, jitter=0.5, dropout=0.2)
    sched = mod_scheduler(lat, n_clients=8, concurrency=4, seed=seed)
    sched.fill(0)
    out = []
    for v in range(1, versions):
        ev = sched.next_completion()
        out.append((float(ev.time), ev.seq, ev.client_id, ev.version,
                    ev.dropped))
        sched.fill(v)
    return out, sched


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_scheduler_trace_matches_reference(seed):
    want, jsched = _trace(JaxScheduler, JaxLatency, seed)
    got, tsched = _trace(SimScheduler, LatencyModel, seed)
    assert got == want
    assert any(d for *_, d in got)                 # dropout happened
    assert tsched.state() == jsched.state()
    # a restored scheduler continues the same stream
    again = SimScheduler(LatencyModel(heterogeneity=1.0, jitter=0.5,
                                      dropout=0.2), 8, 4, seed=seed)
    again.load_state(tsched.state())
    again.restore_events(tsched._heap)
    for _ in range(5):
        a, b, c = (s.next_completion() for s in (again, tsched, jsched))
        assert (a.time, a.seq, a.client_id) == (b.time, b.seq, b.client_id) \
            == (c.time, c.seq, c.client_id)
        for s in (again, tsched, jsched):
            s.fill(99)


@pytest.mark.parametrize("mode, kw", [("none", {}), ("poly", {"alpha": 0.5}),
                                      ("poly", {"alpha": 1.3}),
                                      ("hinge", {"hinge_threshold": 2})])
def test_staleness_weights_match_reference(mode, kw):
    want, got = jax_staleness_weight(mode, **kw), make_staleness_weight(
        mode, **kw)
    assert [got(s) for s in range(12)] == [want(s) for s in range(12)]
    with pytest.raises(ValueError):
        make_staleness_weight("bogus")


def test_async_config_rules_match_reference():
    for kw in (dict(buffer_size=0), dict(concurrency=0),
               dict(max_staleness=-1)):
        with pytest.raises(ValueError):
            JaxAsyncConfig(**kw)
        with pytest.raises(ValueError):
            AsyncConfig(**kw)
    for kw, n, part in ((dict(buffer_size=3), 10, 0.2),
                        (dict(buffer_size=2, concurrency=50), 6, 0.5),
                        (dict(buffer_size=5, concurrency=4), 10, 0.2)):
        try:
            want = JaxAsyncConfig(**kw).resolve_concurrency(n, part)
        except ValueError:
            with pytest.raises(ValueError, match="exceeds"):
                AsyncConfig(**kw).resolve_concurrency(n, part)
        else:
            assert AsyncConfig(**kw).resolve_concurrency(n, part) == want


def test_stage_client_batches_draws_in_reference_order():
    def batch_fn(cid, rng):
        return {"x": rng.standard_normal((3, 2)).astype(np.float32) + cid,
                "y": rng.integers(0, 9, size=3)}
    want = jax_stage_client(batch_fn, 4, 5, np.random.default_rng(1))
    got = stage_client_batches(batch_fn, 4, 5, np.random.default_rng(1),
                               "cpu")
    for k in ("x", "y"):
        assert tuple(got[k].shape) == (1, *np.asarray(want[k]).shape)
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]))


# ------------------------------------------------------ one-client messages

@pytest.mark.parametrize("spec, wire", [("dense", "f32"), ("qblock", "f32"),
                                        ("lowrank_svd+qblock", "bf16")])
def test_concat_clients_joins_one_client_messages(spec, wire):
    """Joining S one-client messages along the client axis gives the
    cohort's message, payloads, shapes and a chain's envelopes alike, so
    the flush and the byte count see what a sync round would."""
    codec = T.resolve_codec(spec, T.TransportConfig(rank=2, wire_dtype=wire))
    r = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(r.standard_normal((3, 6, 5)).astype(
        np.float32)), "b": [torch.from_numpy(r.standard_normal(
            (3, 300)).astype(np.float32))]}
    whole = codec.encode(tree)
    parts = [codec.encode(tree_map(lambda x: x[i:i + 1], tree))
             for i in range(3)]
    joined = T.concat_clients(parts)
    assert T.wire_bytes(joined) == T.wire_bytes(whole)
    assert joined.codec == whole.codec

    def flat(msg):
        out = []
        for m in tree_leaves(msg.leaves) + [
                m for f in msg.envelopes for m in tree_leaves(f)]:
            out.append((m.kind, m.shape, m.dtype, m.extra))
            out += [(k, v) for k, v in sorted((m.parts or {}).items())]
        return out

    for (a, b) in zip(flat(joined), flat(whole)):
        if isinstance(a[1], torch.Tensor):
            assert a[0] == b[0] and torch.equal(a[1], b[1])
        else:
            assert a == b
    w = torch.tensor([1.0, 0.5, 0.25])
    for x, y in zip(tree_leaves(codec.accumulate(joined, w)),
                    tree_leaves(codec.accumulate(whole, w))):
        assert torch.equal(x, y)
    dense = T.concat_clients([tree_map(lambda x: x[i:i + 1], tree)
                              for i in range(3)])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(dense),
                                                 tree_leaves(tree)))
    assert T.concat_clients([None, None]) is None


# -------------------------------------------------------- zero staleness

@pytest.mark.parametrize("algo, kw", [
    ("fedpac_soap", {}), ("fedpac_sophia", dict(lr=2e-2, **QBLOCK))])
def test_zero_staleness_flush_is_the_sync_round_bitwise(algo, kw):
    """A flush of the cohort's wire messages with w_i = 1 equals the sync
    round on the same cohort bitwise: params, Theta, g_G, the controller
    and the telemetry."""
    scn = materialize(_tiny(resolve_scenario("cifar_like_cnn")), seed=0,
                      n_clients=6, device="cpu")
    fed = FedConfig(algorithm=algo, n_clients=6, local_steps=K,
                    device="cpu", **kw)
    spec = resolve(algo)
    opt = spec.make_optimizer()
    transport = fed.make_transport(spec)
    lr = fed.lr if fed.lr is not None else 0.05
    round_fn = build_round_fn(spec, scn.loss_fn, opt, lr=lr, local_steps=K,
                              beta=0.5, transport=transport, n_clients=6,
                              telemetry=True)
    server = init_server(scn.params, geom=make_controller(
        0.5, correct=True, device="cpu"))
    proto = round_client_state_spec(spec, transport)
    cstate = proto.init(scn.params, 6) if proto is not None else None
    cohort = [1, 4, 5]
    rng = np.random.default_rng(3)
    batches = {k: torch.from_numpy(np.stack([np.stack(
        [scn.client_batch_fn(c, rng)[k] for _ in range(K)])
        for c in cohort])) for k in ("x", "y")}
    new_server, _, sync_metrics = round_fn(server, cstate, cohort, batches, 7)

    theta0 = zero_theta(opt, scn.params)
    run = LocalRunConfig(lr=lr, local_steps=K, align=True)
    step = make_wire_client_step(
        spec, make_local_update(spec, scn.loss_fn, opt, run), transport,
        proto, fused=True, cohort_exec=make_cohort_executor(None))
    fresh = proto.init(scn.params, 6) if proto is not None else None
    dmsg, tmsg, _, _ = step(scn.params, theta0, server.g_global,
                            server.geom.beta, fresh,
                            torch.tensor(cohort), batches, seed=7)
    flush = make_async_aggregate_fn(lr=lr, local_steps=K, align=True,
                                    transport=transport, telemetry=True)
    p, th, g, ctrl, metrics = flush(
        scn.params, theta0, server.g_global, server.geom, dmsg, tmsg,
        torch.ones(3), torch.zeros(3, dtype=torch.int32))
    for want, got in ((new_server.params, p), (new_server.theta, th),
                      (new_server.g_global, g)):
        for x, y in zip(tree_leaves(want), tree_leaves(got)):
            assert torch.equal(x, y)
    assert torch.equal(ctrl.beta, new_server.geom.beta)
    for k in ("drift", "norm_drift", "freshness"):
        assert torch.equal(metrics[k], sync_metrics[k])
    ts, ta = sync_metrics["telemetry"], metrics["telemetry"]
    for f in dataclasses.fields(ts):
        assert torch.equal(getattr(ts, f.name), getattr(ta, f.name)), f.name
    assert ta.staleness_hist.tolist() == [3, 0, 0, 0, 0, 0, 0, 0]


# -------------------------------------------------------- whole histories

def _reference_probes_one(key, shapes):
    keys = jax.random.split(key, len(shapes))
    return [jax.random.rademacher(k, s).astype(jnp.float32)
            for k, s in zip(keys, shapes)]


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _dispatch_probes(seed, k_steps, k, shapes):
    """Step ``k``'s probes of a dispatch whose key is
    ``jax.random.key(seed)``: dispatch key -> K steps -> leaves."""
    step_key = jax.random.split(jax.random.key(seed), k_steps)[k]
    return _reference_probes_one(step_key, shapes)


def _async_cfg(mod_cfg, mod_latency, acfg):
    acfg = dict(acfg)
    return mod_cfg(latency=mod_latency(**acfg.pop("latency")), **acfg)


def _jax_run(run):
    r = RUNS[run]
    scn = jax_resolve_scenario("cifar_like_cnn")
    from repro.obs import MemorySink as JaxSink, attach as jax_attach
    exp = jax_build(r["algo"], scenario=_tiny(scn), rounds=FLUSHES,
                    local_steps=K, participation=1.0, n_clients=6,
                    async_cfg=_async_cfg(JaxAsyncConfig, JaxLatency,
                                         r["acfg"]), **r["kw"])
    sink = JaxSink()
    jax_attach(exp, sink)
    hist = exp.run()
    return (hist, sink.events, exp.comm_bytes_per_round(),
            jax.tree.map(np.asarray, exp.scenario.params),
            exp.total_dropped, exp.total_discarded)


@pytest.fixture(scope="module")
def jax_runs():
    return {run: _jax_run(run) for run in RUNS}


def _port_run(run, jax_params):
    r = RUNS[run]
    scn = materialize(_tiny(resolve_scenario("cifar_like_cnn")), seed=0,
                      n_clients=6, device="cpu")
    scn = dataclasses.replace(scn, params=params_from_numpy(jax_params, "cpu"))
    exp = build_experiment(r["algo"], scenario=scn, rounds=FLUSHES,
                           local_steps=K, participation=1.0, device="cpu",
                           async_cfg=_async_cfg(AsyncConfig, LatencyModel,
                                                r["acfg"]), **r["kw"])
    if exp.opt.needs_hessian:
        shapes = tuple(tuple(x.shape) for x in tree_leaves(exp.server.params))
        like = tree_map(lambda p: p[None], exp.server.params)

        def probe_fn(seed, k):
            leaves = _dispatch_probes(seed, K, k, shapes)
            by_path = {path: torch.from_numpy(np.asarray(x)[None])
                       for (path, _), x in zip(tree_flatten_with_path(like),
                                               leaves)}
            return tree_map_with_path(lambda path, _: by_path[path], like)

        exp.probe_fn = probe_fn
    sink = MemorySink()
    attach(exp, sink)
    return exp.run(), sink.events, exp


@pytest.mark.parametrize("run", list(RUNS))
def test_async_history_and_trace_match_reference(jax_runs, run):
    want, want_events, want_bytes, jax_params, dropped, discarded = \
        jax_runs[run]
    got, events, exp = _port_run(run, jax_params)
    assert isinstance(exp, AsyncFederatedExperiment)
    tol, rel = ((SOAP_TOL, SOAP_REL_TOL) if run == "fedpac_soap"
                else (SOPHIA_TOL, SOPHIA_REL_TOL))
    assert len(got) == len(want) == FLUSHES
    assert _mismatches(want, got, tol, rel) == []
    assert exp.comm_bytes_per_round() == want_bytes
    assert (exp.total_dropped, exp.total_discarded) == (dropped, discarded)
    for ev in events:
        validate_event(ev)
    assert _skeleton(events) == _skeleton(want_events)
    drops = [e for e in events if e["event"] == "client_dropped"]
    assert len(drops) == dropped + discarded
    # the buffer's staleness, binned; the telemetry at the round tolerances
    for w, g in zip([e for e in want_events if e["event"] == "round"],
                    [e for e in events if e["event"] == "round"]):
        assert g["telemetry"]["staleness_hist"] == \
            w["telemetry"]["staleness_hist"]
        assert sum(g["telemetry"]["staleness_hist"]) == 2
        for k in ("beta", "freshness"):
            assert g["telemetry"][k] == pytest.approx(w["telemetry"][k],
                                                      abs=1e-7)
        for k in ("drift", "norm_drift"):
            assert g["telemetry"][k] == pytest.approx(
                w["telemetry"][k], rel=rel[k])
    if run == "fedpac_soap":
        assert dropped > 0
    else:
        # max_staleness discards, restored into the EF residual rows
        assert discarded > 0
        assert exp.transport.feedback_active
        assert tuple(exp._ef_state["stem"].shape) == (
            6, *exp.server.params["stem"].shape)


# ------------------------------------------------------------ runtime rules

@pytest.fixture(scope="module")
def tiny_cpu():
    return materialize(_tiny(resolve_scenario("cifar_like_cnn")), seed=0,
                       n_clients=6, device="cpu")


def test_build_experiment_runtime_rules(tiny_cpu):
    acfg = AsyncConfig(buffer_size=2)
    exp = build_experiment("fedavg", scenario=tiny_cpu, device="cpu",
                           async_cfg=acfg)
    assert isinstance(exp, AsyncFederatedExperiment) and exp.acfg is acfg
    assert exp.fed.runtime == "async"
    exp = build_experiment("fedavg", scenario=tiny_cpu, device="cpu",
                           runtime="async")
    assert isinstance(exp, AsyncFederatedExperiment)
    with pytest.raises(ValueError, match="async_cfg"):
        build_experiment("fedavg", scenario=tiny_cpu, device="cpu",
                         runtime="sync", async_cfg=acfg)
    with pytest.raises(ValueError, match="async_cfg"):
        build_experiment("fedavg", scenario=tiny_cpu, async_cfg=acfg,
                         fed=FedConfig(n_clients=6, device="cpu"))
    # traffic= selects the continuous-traffic runtime, never a sync one
    with pytest.raises(ValueError, match="sync"):
        build_experiment("fedavg", scenario=tiny_cpu, device="cpu",
                         runtime="sync", traffic=TrafficConfig())
    assert isinstance(build_experiment(
        "fedavg", scenario=tiny_cpu, device="cpu",
        traffic=TrafficConfig(trace_kwargs={"rate": 2.0})), TrafficExperiment)
    # population mode is ported: a population object needs the config's
    # population knobs
    with pytest.raises(ValueError, match="population_size is not set"):
        build_experiment("fedavg", scenario=tiny_cpu, device="cpu",
                         async_cfg=acfg, population=object())
    with pytest.raises(ValueError, match="lock-step"):
        build_experiment("scaffold", scenario=tiny_cpu, device="cpu",
                         async_cfg=acfg)
    with pytest.raises(ValueError, match="runtime"):
        FedConfig(runtime="bogus", device="cpu")


def test_make_experiment_dispatch(tiny_cpu):
    params, loss_fn, batch_fn, _ = tiny_cpu.problem()
    fed = FedConfig(algorithm="fedavg", n_clients=6, rounds=1, device="cpu")
    assert not isinstance(make_experiment(fed, params, loss_fn, batch_fn),
                          AsyncFederatedExperiment)
    fed_async = dataclasses.replace(fed, runtime="async")
    exp = make_experiment(fed_async, params, loss_fn, batch_fn)
    assert isinstance(exp, AsyncFederatedExperiment)
    with pytest.raises(ValueError, match="async_cfg"):
        make_experiment(fed, params, loss_fn, batch_fn,
                        async_cfg=AsyncConfig())
    # a rerun from the same seed is bit-identical
    hists = [build_experiment(
        "fedpac_soap", scenario=tiny_cpu, device="cpu", rounds=2,
        local_steps=K, async_cfg=AsyncConfig(buffer_size=2)).run()
        for _ in range(2)]
    assert hists[0] == hists[1]
