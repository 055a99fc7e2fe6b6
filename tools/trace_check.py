"""Check the program's span stamps against the benchmark's trace clock, and
measure what tracing costs a round, in one cell of the benchmark.

    python3 tools/trace_check.py --workload vit_tiny.fedpac_soap.c20 \
        [--seed 2718281829] [--pairs 3] [--out build/trace_check]

First, while the process is young enough for the profiler to keep every
kernel, times ``PROBES`` small kernels under the profiler, each launched
on an idle card right after a ``time.time_ns()`` reading, and prints the
gaps from each reading to the kernel's start in the trace: a launch
latency, microseconds, where the profiler's device stamps are on the
spans' epoch clock.  Then sets the cell up as ``fedbench/run.py`` does
(its checked rounds included), and:

1. traces one round as a ``--trace 1`` run of the benchmark does (CUDA
   activity, the harness's sink, its marker kernel first) and compares
   each span's start and end as its ``t0_ns``/``t1_ns`` stamps put them
   on the profiler's clock with those the harness estimates (the sink's
   receipt of the span, less its duration, put on the device clock by
   the marker); prints the offsets' median and largest, the marker's gap
   from its launch to its start in the trace, the card's idle ms by
   innermost span (``fedbench.spanidle``), each span's host ms and the
   round's counters;
2. runs ``2 * pairs`` rounds in turns (none, sink, sink, none, ...)
   without a sink and with a ``MemorySink`` attached, and prints each
   round's host seconds and the two medians.

The offsets and the idle split are also given for the alignment with the
marker's launch put where it happened, ``t0 - t_mark`` before the
window's start (``corrected``): the harness adds that time to the
marker's device stamp with the opposite sign.

Prints one JSON object as its last line and writes it to
``<out>/<workload>.json``.  Needs a CUDA device; imports nothing of JAX.
"""
import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROBES = 20


def clock_probe(torch, devtrace):
    """Microseconds from a ``time.time_ns()`` reading to the start, in the
    profiler's trace, of a kernel launched right after it on an idle
    card, ``PROBES`` times."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")
    read = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROBES):
            torch.cuda.synchronize()
            read.append(time.time_ns())
            x.add_(1.0)
        torch.cuda.synchronize()
    starts = [s for _, s, _ in devtrace.device_ops(prof)]
    if len(starts) != len(read):         # the trace lost a kernel
        print(f"trace_check: {len(starts)} probe kernels traced of "
              f"{len(read)}", file=sys.stderr)
        return []
    return [(s - r) / 1e3 for s, r in zip(starts, read)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2718281829)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "trace_check"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from fedbench.run import _environment
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("trace_check: needs a CUDA device", file=sys.stderr)
        return 1
    from fedbench import devtrace, harness, spanidle, spec
    from repro_torch.obs import MemorySink, attach, counters

    class Run(harness.Run):
        def _trace_context(self, prof, sink, t_mark, t0, t1, events_s):
            self.raw = devtrace.device_ops(prof)
            self.sink_events = list(sink.events)
            self.marks = (t_mark, t0)
            return super()._trace_context(prof, sink, t_mark, t0, t1,
                                          events_s)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest, cat = spec.load_manifest(), spec.Catalog()
    wl = spec.workload(manifest, args.workload)
    run = Run(wl, cat.config(wl["config"]), cat.traffic(wl["traffic"]),
              cat.cell(wl["name"]), seed=args.seed, seconds=0, trace=True)
    probe_us = clock_probe(torch, devtrace)   # while the process is young
    run.setup()
    exp, dev = run.exp, torch.device("cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.t_start
    run.attempted = run.failed = 0
    # one pair of readings puts the host's perf_counter on the epoch clock
    epoch_ns, perf = time.time_ns(), time.perf_counter()
    run._traced_rounds(exp, dev, torch.cuda.synchronize)
    t_mark, t0 = run.marks
    base = run.raw[0][1] - (t0 - t_mark) * 1e9   # the harness's alignment
    marker_gap_us = (run.raw[0][1]
                     - (epoch_ns + (t_mark - perf) * 1e9)) / 1e3
    offsets = []                 # stamps less the harness's estimate, ms
    for ev, received in run.sink_events:
        if ev.get("event") != "span":
            continue
        for stamp, est in ((ev["t0_ns"], received - ev["dur_s"]),
                           (ev["t1_ns"], received)):
            offsets.append(((stamp - base) * 1e-9 - (est - t0)) * 1e3)
    # the marker launched (t0 - t_mark) before the window's start
    corrected = [o - 2e3 * (t0 - t_mark) for o in offsets]
    ctx, traced_counts = run.trace_ctx, counters.last_traced_round()
    idle = spanidle.idle_by_span(ctx.ops, ctx.spans, 0.0, ctx.window_s)
    shift = 2.0 * (t0 - t_mark)
    idle_corrected = spanidle.idle_by_span(
        [devtrace.Op(o.name, o.start - shift, o.dur) for o in ctx.ops],
        ctx.spans, 0.0, ctx.window_s)
    rounds = {"none": [], "sink": []}
    for i in range(args.pairs):
        for kind in (("none", "sink") if i % 2 == 0 else ("sink", "none")):
            if kind == "sink":
                attach(exp, MemorySink())
            else:
                attach(exp)
            torch.cuda.synchronize()
            t = time.perf_counter()
            exp.run_round()
            torch.cuda.synchronize()
            rounds[kind].append(time.perf_counter() - t)
    attach(exp)
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(dev),
        "setup_s": setup_s, "setup_rounds_s": run.setup_rounds,
        "marker_gap_us": marker_gap_us,
        "marker_launch_ms": 1e3 * (t0 - t_mark),
        "span_offset_ms": {"n": len(offsets),
                           "median": statistics.median(offsets),
                           "largest": max(offsets, key=abs)},
        "span_offset_ms_corrected": {
            "median": statistics.median(corrected),
            "largest": max(corrected, key=abs)},
        "probe_us": probe_us,
        "omega_draw_s": counters.snapshot()["omega.draw_s"],
        "window_s": ctx.window_s, "busy_s": ctx.busy_seconds(),
        "idle_ms_by_span": {k: 1e3 * v for k, v in idle.items()},
        "idle_ms_by_span_corrected": {k: 1e3 * v
                                      for k, v in idle_corrected.items()},
        "host_ms_by_span": {k: 1e3 * ctx.span_seconds(k)
                            for k in {n for n, _, _ in ctx.spans}},
        "counters": traced_counts,
        "breakdown": ctx.breakdown(),
        "round_s": rounds,
        "round_s_median": {k: statistics.median(v)
                           for k, v in rounds.items() if v},
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, args.workload + ".json"), "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
