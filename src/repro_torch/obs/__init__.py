"""Observability (counterpart of ``repro/obs``): drift telemetry computed
on the device inside the round, round-trace spans, pluggable sinks, kernel
profiling and the BENCH_*.json document format.

Attach a trace to any experiment (both runtimes):

    from repro_torch.obs import JsonlSink, attach
    exp = build_experiment("fedpac_soap", scenario="cifar_like_cnn")
    attach(exp, JsonlSink("runs/trace.jsonl"))
    exp.run()

The trace then carries one ``round`` event per server update (metrics +
``Telemetry``: drift norm, beta trajectory, staleness histogram,
per-client geometry distances, update/correction alignment, and the
round's ``obs.counters``: kernel launches, Omega copies and draws) plus
``span`` events for each phase, nested and stamped on the profiler's
clock, and explicit ``client_dropped`` events from the async scheduler.
``FedExperiment.log_round`` routes through the same ``Sink`` protocol
(``exp.sink``), defaulting to the reference's stdout formatting.
"""
from repro_torch.obs.bench import (  # noqa: F401
    BENCH_SCHEMA_VERSION, make_bench, read_bench, validate_bench,
    write_bench,
)
from repro_torch.obs.sinks import (  # noqa: F401
    CsvSink, JsonlSink, MemorySink, Sink, StdoutRoundSink, format_metric,
)
from repro_torch.obs.telemetry import (  # noqa: F401
    STALENESS_BINS, Telemetry, client_geom_dist, collect,
    staleness_histogram, telemetry_dict,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER, PHASES, Tracer, validate_event, validate_jsonl,
)

__all__ = [
    "BENCH_SCHEMA_VERSION", "CsvSink", "JsonlSink", "MemorySink",
    "NULL_TRACER", "PHASES", "STALENESS_BINS", "Sink", "StdoutRoundSink",
    "Telemetry", "Tracer", "attach", "client_geom_dist", "collect",
    "format_metric", "make_bench", "profile_kernels", "read_bench",
    "staleness_histogram", "telemetry_dict", "validate_bench",
    "validate_event", "validate_jsonl", "write_bench",
]


def attach(exp, *sinks, run_id=None) -> Tracer:
    """Wire trace sinks into an experiment; returns the live ``Tracer``.

    ``exp`` is any ``FedExperiment``; subsequent rounds emit span/round/
    drop events into every sink.  Passing no sinks detaches (restores the
    disabled tracer)."""
    tracer = Tracer(sinks=sinks, run_id=run_id)
    exp.tracer = tracer
    return tracer


def profile_kernels(*args, **kwargs):
    """Lazy re-export of ``repro_torch.obs.profiling.profile_kernels``
    (imports the kernel packages only when profiling is requested)."""
    from repro_torch.obs.profiling import profile_kernels as _pk
    return _pk(*args, **kwargs)
