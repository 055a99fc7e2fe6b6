"""The readers of the program's nested spans and counters on hand-built
traces: the card's idle time split at span boundaries and given to the
innermost span open (``spanidle``), the ``idle.*``, ``telemetry_ms``,
``omega_*`` and ``kernel_launches`` readers, and what each reads from a
program without those spans or counters (nothing, and no error)."""
import json
import os

import pytest

from fedbench import HERE, devtrace, harness, spanidle, spec

Op = devtrace.Op
# a round of 10 s: staging, then update with local_update (and SOAP's
# refresh inside it), aggregate and telemetry nested, then eval
SPANS = [("staging", 0.0, 1.0), ("soap_refresh", 1.5, 1.0),
         ("local_update", 1.0, 4.0), ("aggregate", 5.5, 0.5),
         ("telemetry", 6.0, 1.5), ("update", 1.0, 7.0), ("eval", 8.5, 1.0)]
# busy [0.5, 1.2], [2.0, 2.2], [3.0, 5.2], [6.5, 7.0], [9.0, 9.5]
OPS = [Op("Memcpy HtoD (Pageable -> Device)", 0.5, 0.7),
       Op("geqr2_batch_kernel", 2.0, 0.2), Op("sm80_xmma_gemm", 3.0, 2.2),
       Op("Memcpy HtoD (Pageable -> Device)", 6.5, 0.5),
       Op("softmax_kernel", 9.0, 0.5)]
IDLE = {  # seconds, by innermost span
    "staging": 0.5,                         # [0, 0.5]
    "local_update": 0.3 + 0.5,              # [1.2, 1.5], [2.5, 3.0]
    "soap_refresh": 0.5 + 0.3,              # [1.5, 2.0], [2.2, 2.5]
    "update": 0.3 + 0.5,                    # [5.2, 5.5], [7.5, 8.0]
    "aggregate": 0.5,                       # [5.5, 6.0]
    "telemetry": 0.5 + 0.5,                 # [6.0, 6.5], [7.0, 7.5]
    "eval": 0.5,                            # [8.5, 9.0]
    "outside_spans": 0.5 + 0.5,             # [8.0, 8.5], [9.5, 10.0]
}


def _ctx(spans=SPANS, ops=OPS, rounds=1):
    with open(os.path.join(HERE, "configs", "vit_tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", "fedpac_soap.c20.json")) as f:
        tr = json.load(f)
    return harness.TraceContext(ops, spans, 10.0 * rounds, rounds, cfg, tr,
                                events_s=9.0 * rounds)


def _read(name, ctx):
    return spec.Catalog().metric(name).read(ctx)


def test_idle_is_split_at_span_boundaries_to_the_innermost_span():
    got = spanidle.idle_by_span(OPS, SPANS, 0.0, 10.0)
    assert set(got) == set(IDLE)
    for name, want in IDLE.items():
        assert got[name] == pytest.approx(want), name
    # the pieces add up to the window's idle time, as device_idle reads it
    assert sum(got.values()) == pytest.approx(
        10.0 - devtrace.busy_seconds(OPS, 0.0, 10.0))


def test_a_gap_straddling_two_spans_is_shared_between_them():
    spans = [("local_update", 0.0, 4.0), ("aggregate", 4.0, 2.0),
             ("update", 0.0, 6.0)]
    ops = [Op("gemm", 0.0, 3.0), Op("gemm", 5.0, 1.0)]
    got = spanidle.idle_by_span(ops, spans, 0.0, 6.0)
    assert got == pytest.approx({"local_update": 1.0, "aggregate": 1.0})
    # the breakdown names the whole gap by the span open at its middle
    assert devtrace.breakdown(ops, spans, 0.0, 6.0)["idle_gaps"] == [
        ["aggregate", pytest.approx(2.0)]]


@pytest.mark.parametrize("name,want_ms", [
    ("idle.local_update", 1e3 * IDLE["local_update"]),
    ("idle.soap_refresh", 1e3 * IDLE["soap_refresh"]),
    ("telemetry_ms", 1500.0),
])
def test_span_readers_on_a_synthetic_trace(name, want_ms):
    assert _read(name, _ctx()) == pytest.approx(want_ms)
    # two traced rounds of the same: the same per round
    twice = [(n, a + 10.0 * r, d) for r in range(2) for n, a, d in SPANS]
    ops2 = [Op(o.name, o.start + 10.0 * r, o.dur) for r in range(2)
            for o in OPS]
    assert _read(name, _ctx(twice, ops2, rounds=2)) == pytest.approx(want_ms)


@pytest.mark.parametrize("name", ["idle.local_update", "idle.soap_refresh",
                                  "telemetry_ms"])
def test_span_readers_read_nothing_without_their_span(name):
    """A program whose round has only staging, update and eval (the
    parent of the nested spans) reads None, not 0."""
    bare = [s for s in SPANS if s[0] in ("staging", "update", "eval")]
    assert _read(name, _ctx(bare)) is None


def test_a_span_present_with_no_idle_reads_zero():
    spans = SPANS + [("encode", 3.5, 0.5)]       # inside a busy stretch
    assert spanidle.idle_ms(_ctx(spans), "encode") == 0.0


def test_idle_readers_stay_within_device_idle():
    ctx = _ctx()
    idle_ms = (_read("idle.local_update", ctx)
               + _read("idle.soap_refresh", ctx))
    assert idle_ms <= _read("device_idle", ctx) / 100 * ctx.window_s * 1e3


def test_counter_readers_on_a_recorded_round(monkeypatch):
    from repro_torch.obs import counters
    monkeypatch.setattr(counters, "_last_traced_round", None)
    monkeypatch.setattr(counters, "_totals",
                        {"omega.h2d_bytes": 9_000_000_000,
                         "omega.draw_s": 31.5})
    ctx = _ctx()
    assert _read("omega_h2d_MB", ctx) is None       # no round traced yet
    assert _read("kernel_launches", ctx) is None
    assert _read("omega_draw_s", ctx) == 31.5
    counters.record_traced_round({
        "omega.h2d_bytes": 8_400_000_000, "omega.draw_s": 0.0,
        "launches.adam_moments": 1270, "launches.matmul_fused": 50,
        "launches.newton_schulz_group": 0})
    assert _read("omega_h2d_MB", ctx) == 8400.0
    assert _read("kernel_launches", ctx) == 1320
    assert _read("omega_draw_s", ctx) == 31.5


def test_counter_readers_read_nothing_without_the_counters(monkeypatch):
    """A program without ``repro_torch.obs.counters`` (the parent of the
    counters) reads None, and no reader raises."""
    import builtins
    real = builtins.__import__

    def no_counters(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch.obs" and "counters" in (fromlist or ()):
            raise ImportError("no counters")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_counters)
    for name in ("omega_h2d_MB", "omega_draw_s", "kernel_launches"):
        assert _read(name, _ctx()) is None, name
