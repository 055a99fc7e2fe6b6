"""The port's continuous-traffic runtime (``repro_torch.fed.traffic``)
against the JAX package's: the arrival processes and churn draws (numpy
copies: bitwise, with their ``state()``/``load_state()`` continuations),
the saturating trace against the port's own round-shaped async runtime
(metric for metric), diurnal, bursty and piecewise streams with churn,
anytime eval and both buffer policies, a mid-stream hot-swap and
``run_ab`` on a shared trace, a mid-stream checkpoint restored into a
fresh experiment, and the eviction of a departed client's error-feedback
row.  The problem is the reference tests' tiny 2-layer MLP
(``tests/test_traffic.py:_mlp_problem``), its batches as dicts, the same
numpy draws on both sides.

Tolerances:
  * arrival times, churn draws, the traced event stream (kinds, client
    ids, versions, drop reasons, in-flight flags, sim times) and the
    simulated fields of a history: exact.
  * history and eval-history metrics: the async tolerances
    (tests/test_torch_async.py): loss 5e-3, acc 6/768 absolute (the
    reference's test_acc tolerance), drift and norm_drift 5% relative;
    ``fedpac_soap`` at eps=1e-3 as there.
  * the saturating stream against the round-shaped run and a restored
    checkpoint against the uninterrupted run: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import (
    AsyncConfig as JaxAsyncConfig, ChurnConfig as JaxChurn,
    TrafficConfig as JaxTrafficConfig, build_experiment as jax_build,
)
from repro.core.algorithms import resolve as jax_resolve
from repro.fed.async_runtime import LatencyModel as JaxLatency
from repro.fed.traffic import (
    BurstyRate as JaxBursty, ConstantRate as JaxConstant,
    DiurnalRate as JaxDiurnal, Membership as JaxMembership,
    PiecewiseRate as JaxPiecewise, run_ab as jax_run_ab,
)
from repro.obs import MemorySink as JaxSink, attach as jax_attach
from repro_torch.api import (
    AsyncConfig, AsyncFederatedExperiment, BurstyRate, ChurnConfig,
    ConstantRate, DiurnalRate, LatencyModel, PiecewiseRate, TrafficConfig,
    TrafficExperiment, build_experiment, resolve, run_ab, time_to_quality,
)
from repro_torch.fed.traffic import Membership
from repro_torch.obs import MemorySink, attach, validate_event
from repro_torch.utils.tree import tree_leaves

K = 2
TOL = {"loss": 5e-3, "acc": 6 / 768}
REL_TOL = {"drift": 0.05, "norm_drift": 0.05}
EXACT = ("sim_time", "staleness", "max_staleness", "dropped", "discarded",
         "round")
ACFG = dict(buffer_size=3, concurrency=4)
LATENCY = dict(heterogeneity=1.0, jitter=0.5, dropout=0.1)
SOAP_KW = dict(opt_kwargs={"eps": 1e-3})


# ------------------------------------------------------------- problem

def _mlp_arrays(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(240, 8)).astype(np.float32)
    y = rng.integers(0, 3, size=240).astype(np.int32)
    params = {"w1": (rng.normal(size=(8, 16)) * 0.1).astype(np.float32),
              "b1": np.zeros((16,), np.float32),
              "w2": (rng.normal(size=(16, 3)) * 0.1).astype(np.float32),
              "b2": np.zeros((3,), np.float32)}
    return X, y, params, np.array_split(np.arange(240), 8)


def _batch_fn(X, y, parts):
    def client_batch_fn(cid, rng_):
        sel = rng_.choice(parts[cid % len(parts)], size=32)
        return {"x": X[sel], "y": y[sel]}
    return client_batch_fn


def _jax_problem():
    X, y, params, parts = _mlp_arrays()

    def loss_fn(p, b):
        h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
        logp = jax.nn.log_softmax(h @ p["w2"] + p["b2"])
        return -jnp.mean(jnp.take_along_axis(logp, b["y"][:, None], 1))

    def eval_fn(p):
        h = jnp.tanh(X @ p["w1"] + p["b1"])
        return {"acc": jnp.mean(jnp.argmax(h @ p["w2"] + p["b2"], -1) == y)}

    return dict(params=jax.tree.map(jnp.asarray, params), loss_fn=loss_fn,
                client_batch_fn=_batch_fn(X, y, parts), eval_fn=eval_fn)


def _port_problem():
    X, y, params, parts = _mlp_arrays()
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y).long()

    def loss_fn(p, b):
        h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
        logp = torch.log_softmax(h @ p["w2"] + p["b2"], -1)
        return -torch.mean(torch.gather(logp, 1, b["y"].long()[:, None]))

    def eval_fn(p):
        h = torch.tanh(Xt @ p["w1"] + p["b1"])
        acc = torch.argmax(h @ p["w2"] + p["b2"], -1) == yt
        return {"acc": acc.to(torch.float32).mean()}

    return dict(params={k: torch.from_numpy(v.copy())
                        for k, v in params.items()},
                loss_fn=loss_fn, client_batch_fn=_batch_fn(X, y, parts),
                eval_fn=eval_fn)


def _acfg(jax_side, **kw):
    mod_cfg, mod_lat = ((JaxAsyncConfig, JaxLatency) if jax_side
                        else (AsyncConfig, LatencyModel))
    return mod_cfg(latency=mod_lat(**LATENCY), **{**ACFG, **kw})


def _tcfg(jax_side, churn=None, **kw):
    mod_tc, mod_churn = ((JaxTrafficConfig, JaxChurn) if jax_side
                         else (TrafficConfig, ChurnConfig))
    return mod_tc(churn=mod_churn(**churn) if churn else None, **kw)


def _build(jax_side, algo, tc, acfg=None, **kw):
    kw = dict(n_clients=8, rounds=1, local_steps=K, seed=11, **kw)
    if jax_side:
        exp = jax_build(algo, async_cfg=_acfg(True, **(acfg or {})),
                        traffic=_tcfg(True, **tc), **_jax_problem(), **kw)
        sink = JaxSink()
        jax_attach(exp, sink)
    else:
        exp = build_experiment(algo, async_cfg=_acfg(False, **(acfg or {})),
                               traffic=_tcfg(False, **tc), device="cpu",
                               **_port_problem(), **kw)
        sink = MemorySink()
        attach(exp, sink)
    return exp, sink


def _skeleton(events):
    """The event stream a run must repeat exactly (run_id, seq, dur_s and
    float metrics excluded), top-level events only: the spans the port
    nests in a dispatch or a flush are its own."""
    keys = ("event", "phase", "round", "client_id", "reason", "version",
            "in_flight", "sim_time", "algorithm")
    return [tuple(e.get(k) for k in keys) for e in events
            if "parent" not in e]


def _mismatches(want, got):
    bad = []
    for r, (w, g) in enumerate(zip(want, got)):
        for k in EXACT:
            if k in w and w[k] != g[k]:
                bad.append((r, k, w[k], g[k]))
        for k, t in TOL.items():
            if k in w and abs(w[k] - g[k]) > t:
                bad.append((r, k, w[k], g[k]))
        for k, t in REL_TOL.items():
            if k in w and abs(w[k] - g[k]) > t * abs(w[k]):
                bad.append((r, k, w[k], g[k]))
    return bad


def _assert_matches(jexp, jsink, exp, sink):
    assert len(exp.history) == len(jexp.history) > 0
    assert [set(r) for r in exp.history] == [set(r) for r in jexp.history]
    assert _mismatches(jexp.history, exp.history) == []
    assert [set(r) for r in exp.eval_history] == \
        [set(r) for r in jexp.eval_history]
    assert _mismatches(jexp.eval_history, exp.eval_history) == []
    for ev in sink.events:
        validate_event(ev)
    assert _skeleton(sink.events) == _skeleton(jsink.events)
    assert (exp.total_dropped, exp.total_discarded, exp.backlog) == \
        (jexp.total_dropped, jexp.total_discarded, jexp.backlog)


# ------------------------------------------------------ arrival processes

def _processes(mods):
    constant, diurnal, bursty, piecewise = mods
    return [constant(3.0, seed=5),
            diurnal(4.0, amplitude=0.7, period=6.0, seed=5),
            bursty(2.0, jump=0.5, decay=1.0, seed=5),
            piecewise([1.0, 5.0, 0.5], bin_width=2.0, seed=5),
            piecewise([0.0, 3.0, 1.0], bin_width=1.5, cycle=False, seed=2)]


def _arrivals(proc, n, t=0.0):
    out = []
    for _ in range(n):
        t = proc.next_arrival(t)
        proc.notify_arrival(t)
        out.append(t)
    return out


@pytest.mark.parametrize("i", range(5))
def test_trace_process_matches_reference_and_continues(i):
    want_p = _processes((JaxConstant, JaxDiurnal, JaxBursty, JaxPiecewise))[i]
    got_p = _processes((ConstantRate, DiurnalRate, BurstyRate,
                        PiecewiseRate))[i]
    want, got = _arrivals(want_p, 30), _arrivals(got_p, 30)
    assert got == want and got == sorted(got)
    # a restored process continues the same sequence
    st = got_p.state()
    assert st == want_p.state()
    tail = _arrivals(got_p, 10, got[-1])
    fresh = _processes((ConstantRate, DiurnalRate, BurstyRate,
                        PiecewiseRate))[i]
    fresh.load_state(st)
    assert _arrivals(fresh, 10, got[-1]) == tail == \
        _arrivals(want_p, 10, want[-1])


def test_saturating_constant_rate_and_validation():
    # saturating: an arrival is always due at once
    assert ConstantRate(float("inf")).next_arrival(1.5) == 1.5
    for mod_c, mod_d, mod_b, mod_p, mod_tc in (
            (JaxConstant, JaxDiurnal, JaxBursty, JaxPiecewise,
             JaxTrafficConfig),
            (ConstantRate, DiurnalRate, BurstyRate, PiecewiseRate,
             TrafficConfig)):
        for make, match in ((lambda: mod_c(0.0), "rate"),
                            (lambda: mod_d(1.0, amplitude=1.5), "amplitude"),
                            (lambda: mod_b(1.0, jump=2.0, decay=1.0),
                             "non-stationary"),
                            (lambda: mod_p([0.0, 0.0]), "zero"),
                            (lambda: mod_tc(buffer_policy="nope"),
                             "buffer_policy"),
                            (lambda: mod_tc(buffer_policy="interval"),
                             "flush_interval"),
                            (lambda: mod_tc(swap_to="fedavg"), "swap"),
                            (lambda: mod_tc(trace="nope"), "trace")):
            with pytest.raises(ValueError, match=match):
                make()


def test_membership_draws_match_reference():
    cfg = dict(join_rate=1.0, leave_rate=1.5, initial_active=10, seed=4)
    want, got = JaxMembership(100, JaxChurn(**cfg)), Membership(
        100, ChurnConfig(**cfg))
    sched_w, sched_g = (np.random.default_rng(3) for _ in range(2))

    def draws(m, rng):
        out, t = [], 0.0
        for _ in range(12):
            t, kind = m.next_event(t)
            cid = m.sample_join() if kind == "join" else m.sample_leave()
            out.append((t, kind, cid,
                        m.sample_dispatch(rng, exclude={cid or 0, 5})))
        return out

    assert draws(got, sched_g) == draws(want, sched_w)
    assert got.state() == want.state()
    again = Membership(100, ChurnConfig(**{**cfg, "seed": 99}))
    again.load_state(got.state())
    assert draws(again, np.random.default_rng(7)) == \
        draws(got, np.random.default_rng(7))
    assert got.n_active == again.n_active and all(
        got.is_active(c) for c in got.active_ids())


# ------------------------------------------------------------- streams

def test_saturating_stream_is_the_round_shaped_async_run():
    kw = dict(n_clients=8, rounds=3, local_steps=K, seed=11, device="cpu",
              **SOAP_KW)
    legacy = build_experiment("fedpac_soap", async_cfg=_acfg(False),
                              **_port_problem(), **kw)
    traffic = build_experiment(
        "fedpac_soap", async_cfg=_acfg(False),
        traffic=TrafficConfig(trace="constant",
                              trace_kwargs={"rate": float("inf")}),
        **_port_problem(), **kw)
    assert isinstance(traffic, TrafficExperiment)
    assert type(legacy) is AsyncFederatedExperiment
    want, got = legacy.run(), traffic.run()
    assert len(want) == len(got) == 3
    assert want == got


STREAMS = {
    "diurnal_churn_interval_soap": dict(
        algo="fedpac_soap", kw=SOAP_KW, budget=6.0,
        tc=dict(trace="diurnal",
                trace_kwargs={"base": 6.0, "period": 4.0},
                churn=dict(join_rate=1.5, leave_rate=1.5, initial_active=6,
                           seed=2),
                eval_every=1.0, buffer_policy="interval",
                flush_interval=0.7)),
    "bursty_churn_count_fedavg": dict(
        algo="fedavg", kw={}, budget=6.0,
        tc=dict(trace="bursty",
                trace_kwargs={"base": 4.0, "jump": 0.6, "decay": 1.0},
                churn=dict(join_rate=1.0, leave_rate=2.0, initial_active=5),
                eval_every=1.5)),
    "piecewise_count_fedavg_max_staleness": dict(
        algo="fedavg", kw={}, budget=6.0, acfg=dict(max_staleness=1),
        tc=dict(trace="piecewise",
                trace_kwargs={"rates": [2.0, 9.0, 4.0], "bin_width": 1.0},
                eval_every=2.0)),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_reference(name):
    s = STREAMS[name]
    sides = [_build(j, s["algo"], s["tc"], acfg=s.get("acfg"), **s["kw"])
             for j in (True, False)]
    (jexp, jsink), (exp, sink) = sides
    want = jexp.run_stream(sim_budget=s["budget"])
    got = exp.run_stream(sim_budget=s["budget"])
    for k in ("flushes", "sim_time", "evals", "backlog", "dropped",
              "discarded", "joins", "leaves", "active"):
        assert got[k] == want[k], k
    _assert_matches(jexp, jsink, exp, sink)
    kinds = {e["event"] for e in sink.events}
    assert "anytime_eval" in kinds
    # anytime eval owns the grid: flush records carry no eval metric
    assert all("acc" not in r for r in exp.history)
    if s["tc"].get("churn"):
        assert got["joins"] > 0 and got["leaves"] > 0
        assert {"client_join", "client_leave"} <= kinds


def _soap_eps(jax_side):
    """``fedpac_soap`` at eps=1e-3 through its spec, not ``opt_kwargs``:
    the swap hands the run's ``opt_kwargs`` to the new algorithm, and
    SGD takes no ``eps``."""
    base = (jax_resolve if jax_side else resolve)("fedpac_soap")

    @dataclasses.dataclass(frozen=True)
    class Eps(type(base)):
        def make_optimizer(self, **kw):
            return super().make_optimizer(**{"eps": 1e-3, **kw})

    return Eps(**{f.name: getattr(base, f.name)
                  for f in dataclasses.fields(base)})


def test_hotswap_and_run_ab_match_reference():
    """A mid-stream swap fedpac_soap -> fedavg against a fedavg arm on one
    shared diurnal trace, both arms against the reference's."""
    tc = dict(trace="diurnal", trace_kwargs={"base": 6.0, "period": 4.0},
              eval_every=1.0)
    swap = dict(tc, swap_to="fedavg", swap_at=2.5)
    out = {}
    for j in (True, False):
        a = _build(j, _soap_eps(j), swap)
        b = _build(j, "fedavg", tc)
        ab = (jax_run_ab if j else run_ab)(a[0], b[0], sim_budget=6.0)
        out[j] = (a, b, ab)
    (ja, jb, jab), (pa, pb, pab) = out[True], out[False]
    for (jexp, jsink), (exp, sink) in ((ja, pa), (jb, pb)):
        _assert_matches(jexp, jsink, exp, sink)
    assert pa[0].spec.name == "fedavg"
    swaps = [e for e in pa[1].events if e["event"] == "client_dropped"
             and e["reason"] == "algo_swap"]
    assert swaps and any(r["round"] > 0 for r in pa[0].history)
    assert [r["sim_time"] for r in pa[0].history] != [] and \
        pab["a"]["flushes"] == jab["a"]["flushes"]
    assert pab["eval_a"] == pa[0].eval_history
    for arm in ("a", "b"):
        for k in ("flushes", "sim_time", "evals", "dropped", "discarded"):
            assert pab[arm][k] == jab[arm][k]
    ttq = time_to_quality(pab["eval_b"], "acc", 0.0)
    assert ttq == pab["eval_b"][0]["sim_time"]
    assert time_to_quality(pab["eval_b"], "acc", 2.0) is None


# ---------------------------------------------------------- checkpoints

CKPT = dict(algo="fedpac_soap",
            kw=dict(SOAP_KW, delta_codec="qblock", theta_codec="qblock"),
            tc=dict(trace="diurnal",
                    trace_kwargs={"base": 6.0, "period": 4.0},
                    churn=dict(join_rate=1.0, leave_rate=1.0,
                               initial_active=7, seed=3),
                    eval_every=1.0))


def test_midstream_checkpoint_continues_bitwise(tmp_path):
    """Saved after flush 2 and loaded into a freshly built experiment, the
    stream continues to the uninterrupted run's history, eval history,
    trace and EF residuals, bitwise (qblock wire with error feedback:
    the pickled heap and buffer hold wire messages)."""
    full, full_sink = _build(False, CKPT["algo"], CKPT["tc"], **CKPT["kw"])
    assert full._ef and full._ef_state is not None
    full.run_stream(max_flushes=2)
    d = full.save_checkpoint(str(tmp_path))
    assert sorted(p.name for p in tmp_path.joinpath(
        d.split("/")[-1]).iterdir()) == [
        "ef_state.npz", "g_global.npz", "meta.json", "params.npz",
        "theta.npz", "traffic.json", "traffic_events.pkl"]
    seq0 = full.tracer.seq
    assert full.scheduler._heap or full._buffered
    full.run_stream(sim_budget=6.0)

    resumed, sink = _build(False, CKPT["algo"], CKPT["tc"], **CKPT["kw"])
    resumed.load_checkpoint(str(tmp_path))
    assert resumed.tracer.seq == seq0 and resumed.flushes == 2
    resumed.run_stream(sim_budget=6.0)
    assert resumed.history == full.history
    assert resumed.eval_history == full.eval_history
    assert resumed.sim_now == full.sim_now
    tail = [e for e in full_sink.events if e["seq"] >= seq0]
    assert _skeleton(sink.events) == _skeleton(tail)
    for a, b in zip(tree_leaves(full._ef_state),
                    tree_leaves(resumed._ef_state)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(full.server.params),
                    tree_leaves(resumed.server.params)):
        assert torch.equal(a, b)


def test_evicted_client_ef_row_is_zero_and_buffer_untouched():
    exp, _ = _build(False, CKPT["algo"],
                    dict(CKPT["tc"], buffer_policy="interval",
                         flush_interval=50.0, churn=None),
                    **CKPT["kw"])
    while len(exp._buffered) < 2:
        exp._step()
    ef = exp._ef_state
    rows = [c for c in range(8)
            if any(bool(leaf[c].abs().sum() > 0) for leaf in tree_leaves(ef))]
    assert rows
    cid = rows[0]

    def snapshot(evs):
        return [[t.clone() for t in _payload_tensors(ev.payload)]
                for ev in evs]

    before_buf, before_heap = snapshot(exp._buffered), snapshot(
        exp.scheduler._heap)
    others = [leaf.clone() for leaf in tree_leaves(ef)]
    exp._evict_state(cid)
    for leaf, old in zip(tree_leaves(exp._ef_state), others):
        assert bool((leaf[cid] == 0).all())
        keep = [c for c in range(8) if c != cid]
        assert torch.equal(leaf[keep], old[keep])
    for evs, before in ((exp._buffered, before_buf),
                        (exp.scheduler._heap, before_heap)):
        for ev, old in zip(evs, before):
            now = _payload_tensors(ev.payload)
            assert len(now) == len(old)
            assert all(torch.equal(a, b) for a, b in zip(now, old))


def _payload_tensors(payload):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(payload)
    return out


# ------------------------------------------------- build_experiment rules

def test_build_experiment_traffic_rules(tmp_path):
    prob = _port_problem()
    with pytest.raises(ValueError, match="sync"):
        build_experiment("fedavg", runtime="sync", traffic=TrafficConfig(),
                         n_clients=8, device="cpu", **prob)
    exp = build_experiment("fedavg", traffic=TrafficConfig(
        trace_kwargs={"rate": 4.0}), n_clients=8, device="cpu", **prob)
    assert isinstance(exp, TrafficExperiment) and exp.fed.runtime == "async"
    with pytest.raises(ValueError, match="saturating"):
        build_experiment(
            "fedavg", traffic=TrafficConfig(
                trace_kwargs={"rate": float("inf")},
                churn=ChurnConfig(join_rate=1.0)),
            n_clients=8, device="cpu", **prob)
    with pytest.raises(ValueError, match="sim_budget"):
        exp.run_stream()
    # a budgeted sparse EF store cannot checkpoint mid-stream
    pop = build_experiment(
        "fedavg", traffic=TrafficConfig(trace_kwargs={"rate": 4.0}),
        async_cfg=AsyncConfig(buffer_size=2, concurrency=4),
        population_size=64, cohort_size=4, state_budget=8,
        delta_codec="qblock", device="cpu", **prob)
    pop.run_stream(max_flushes=1)
    with pytest.raises(NotImplementedError, match="sparse EF store"):
        pop.save_checkpoint(str(tmp_path))
