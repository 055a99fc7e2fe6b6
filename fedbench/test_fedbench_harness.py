"""The harness's own rules, without the program: the window's rule, the
JAX guard by whole top-level names, the seeds, the batch recorder, the
trace's union of intervals and its idle gaps, and the comparison."""
import math

import numpy as np
import pytest

from fedbench import checks, devtrace, harness


class FakeExperiment:
    """Rounds of given lengths on a fake clock."""

    def __init__(self, clock, lengths):
        self.clock, self.lengths = clock, iter(lengths)

    def run_round(self):
        self.clock[0] += next(self.lengths)
        return {"loss": 1.0}


@pytest.mark.parametrize("lengths,seconds,want", [
    ([4.0, 6.0, 5.0, 5.0], 15.0, 2),     # 10 s + the longest 6 > 15
    ([5.0, 5.0, 5.0, 5.0], 15.0, 3),     # 10 + 5 fits, 15 + 5 does not
    ([20.0, 1.0], 15.0, 1),              # the first round always runs
    ([1.0] * 100, 50.0, 50),
])
def test_window_starts_a_round_only_while_it_fits(lengths, seconds, want):
    clock = [0.0]
    run = harness.Run.__new__(harness.Run)
    run.exp = FakeExperiment(clock, lengths)
    run.device, run.seconds, run.trace, run.guard = "cpu", seconds, False, \
        False
    run.t_start, run.clock = 0.0, (lambda: clock[0])
    run.window()
    assert run.attempted == want and run.failed == 0
    assert run.round_times == lengths[:want]
    assert run.window_s == sum(lengths[:want])


def test_guard_compares_whole_top_level_names():
    ok = {"repro_torch": 0, "repro_torch.api": 0, "reproducible": 0,
          "jax_like": 0, "numpy": 0}
    assert harness.forbidden_modules(ok) == []
    bad = dict(ok, **{"repro": 0, "repro.core.client": 0, "jaxlib.xla": 0,
                      "flax": 0, "jax": 0})
    assert harness.forbidden_modules(bad) == [
        "flax", "jax", "jaxlib.xla", "repro", "repro.core.client"]


def test_seeds_are_small_fixed_and_distinct():
    for seed in (0, 7, 2**31 - 1, 2**31 + 5, 2**40 + 3, -1):
        s = harness.seeds_of(seed)
        assert s == harness.seeds_of(seed)
        assert all(0 <= v < 2**31 for v in s.values())
        assert len(set(s.values())) == 3
    assert harness.seeds_of(1) != harness.seeds_of(2)


def test_batch_recorder_groups_rounds_clients_steps():
    rec = harness.BatchRecorder(lambda cid, rng: {"x": np.full(2, cid)})
    for r in range(2):
        for cid in (10 * r + 1, 10 * r + 2):
            for _ in range(3):
                rec(cid, None)
    rounds = rec.rounds(2, 3)
    assert [[int(steps[0]["x"][0]) for steps in cohort] for cohort in rounds
            ] == [[1, 2], [11, 12]]
    assert all(len(steps) == 3 for cohort in rounds for steps in cohort)
    with pytest.raises(ValueError):
        rec.rounds(5, 3)


def test_busy_time_is_the_union_and_gaps_are_named():
    Op = devtrace.Op
    ops = [Op("gemm_a", 0.0, 2.0), Op("gemm_b", 1.0, 2.0),   # overlap
           Op("Memcpy HtoD (Pageable -> Device)", 5.0, 1.0),
           Op("geqrf_kernel", 8.0, 1.0)]
    assert devtrace.busy_seconds(ops, 0.0, 10.0) == 5.0
    assert devtrace.idle_gaps(ops, 0.0, 10.0) == [(3.0, 2.0), (6.0, 2.0),
                                                  (9.0, 1.0)]
    spans = [("update", 0.0, 6.5), ("eval", 7.5, 2.5), ("staging", 2.5, 1.0)]
    b = devtrace.breakdown(ops, spans, 0.0, 10.0)
    assert b["device_ops"][0] == ["gemm_a", 2.0]
    assert b["idle_gaps"] == [["update", 2.0], ["outside_spans", 2.0],
                              ["eval", 1.0]]
    assert [devtrace.group_of(o.name) for o in ops] == ["gemm", "gemm", "h2d",
                                                       "qr"]
    assert devtrace.group_of("void at::native::sqrt_kernel") != "qr"


def _readings(scale=1.0):
    return {"loss": [2.0 * scale, 1.5, 1.2], "drift": [3.0, 2.0, 1.0],
            "grad": {"a": 1.0, "b": 2.0 * scale, "c": 1e-9},
            "theta": {"a.L": 4.0, "a.R": 5.0},
            "change": {"a": 0.5, "b": 0.25, "c": 1e-12}}


def test_values_by_the_worst_leaf():
    ref = _readings()
    prog = _readings()
    prog["grad"]["b"] = 2.2              # 0.2 over max(2.0, median 1.0)
    prog["change"]["c"] = 5.0            # left out: its gradient is nought
    prog["change"]["b"] = 0.5            # 0.25 over the median 0.375
    v = checks.values(prog, ref)
    assert v["grad.r1"] == pytest.approx(0.1)
    assert v["change.r3"] == pytest.approx(0.25 / 0.375)
    assert v["loss.r1"] == 0.0 and v["theta.r1"] == 0.0
    prog["theta"] = {}                   # a Theta that never came
    assert checks.values(prog, ref)["theta.r1"] == math.inf
    ok, chk = checks.judge(v, {"grad.r1": 0.2, "loss.r1": 1e-6})
    assert ok and chk["grad.r1"] == {"value": v["grad.r1"], "limit": 0.2}
    assert not checks.judge(v, {"grad.r1": 0.05})[0]
    assert not checks.judge({"x": math.nan}, {"x": 1.0})[0]


def test_metric_readers_on_a_synthetic_trace():
    import json
    import os

    from fedbench import HERE, counts, spec
    with open(os.path.join(HERE, "configs", "vit_tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", "fedpac_soap.c20.json")) as f:
        tr = json.load(f)
    Op = devtrace.Op
    ops = [Op("matmul_fused_group_kernel", 0.5, 0.2),
           Op("geqr2_batch_kernel", 1.0, 1.0),
           Op("sm80_xmma_gemm_f32f32", 1.5, 1.0),       # overlaps the QR
           Op("Memcpy HtoD (Pageable -> Device)", 3.0, 0.01)]
    spans = [("staging", 0.0, 0.1), ("update", 0.1, 3.5), ("eval", 3.6, 0.3)]
    ctx = harness.TraceContext(ops, spans, 4.0, 1, cfg, tr, events_s=3.8,
                               timed_s=9.0, timed_rounds=3)
    cat = spec.Catalog()
    read = {n: cat.metric(n).read(ctx) for n in (
        "staging_ms", "eval_ms", "h2d_copy_ms", "soap_refresh_ms", "gemm_ms",
        "roofline.matmul_fused", "roofline.newton_schulz", "device_idle",
        "round_mfu")}
    assert read["staging_ms"] == pytest.approx(100.0)
    assert read["eval_ms"] == pytest.approx(300.0)
    assert read["h2d_copy_ms"] == pytest.approx(10.0)
    assert read["soap_refresh_ms"] == pytest.approx(1000.0)
    assert read["gemm_ms"] == pytest.approx(1000.0)
    # no newton_schulz kernel in the trace: nothing read, not 0
    assert read["roofline.newton_schulz"] is None
    flops, bytes_ = counts.matmul_fused_work(cfg, tr)
    assert read["roofline.matmul_fused"] == pytest.approx(
        100 * counts.bound_seconds(flops, bytes_) / 0.2)
    assert read["device_idle"] == pytest.approx(100 * (1 - 1.71 / 4.0))
    # from the untraced window: 3 rounds in 9 s
    assert read["round_mfu"] == pytest.approx(
        100 * 3 * counts.round_model_flops(cfg, tr) / (9.0 * 67e12))
    assert ctx.events_share() == pytest.approx(1.71 / 3.8)
