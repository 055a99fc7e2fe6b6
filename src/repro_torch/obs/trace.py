"""Round-trace spans: a structured, simulated-time-aware event log
(counterpart of ``repro/obs/trace.py``, copied: it imports no JAX).

A ``Tracer`` stamps every event with a run id and a monotone sequence
number and fans it out to its sinks.  Phases of a round are recorded as
*spans* carrying both wall-clock duration and (for the async runtime) the
simulated time at which the phase ran; round metrics + jit-pure
``Telemetry`` land as one ``round`` event; client dispatches that never
reach the server (dropout, over-staleness discard) are explicit
``client_dropped`` events rather than silent counter increments.

Event schema (one JSON object per line under ``JsonlSink``):

  common        event, run_id, seq
  span          phase, dur_s, round?, client_id?, chunk?, sim_time?,
                t0_ns?, t1_ns?, id?, parent?
  round         round, metrics{...}, telemetry{...}?, sim_time?,
                counters{...}?
  client_dropped  client_id, reason ("dropout"|"max_staleness"|
                  "client_left"|"algo_swap"), version, sim_time?
  client_join   client_id, sim_time?        (churn: id became active)
  client_leave  client_id, in_flight, sim_time?  (churn: id departed;
                  in_flight work, if any, is voided and later traced as a
                  client_dropped with reason "client_left")
  anytime_eval  metrics{...}, sim_time, round?   (continuous-traffic
                  online eval sampled by simulated time, fed.traffic)
  run_start     runtime, algorithm?, scenario?

An enabled tracer stamps each span with ``time.time_ns()`` at open and at
close (``t0_ns``, ``t1_ns``: the Unix epoch clock, on which
``torch.profiler`` stamps its events, so a span joins any profiler trace),
its own number ``id`` and the ``id`` of the span it is nested in
(``parent``, absent at top level); a nested span without a ``round`` of
its own takes its parent's.  Code deep in the stack (the optimizer's
refresh, the wire encode, the server's flush, telemetry) reaches the live
tracer as ``current()``: each runtime makes its tracer current for a
round, a dispatch or a flush (``Tracer.activate``); elsewhere it is
``NULL_TRACER``.  An enabled tracer also snapshots ``obs.counters`` at a
round's start (the first ``activate`` after the previous round event) and
at its ``round`` event, which carries the differences under ``counters``.

A disabled tracer (no sinks) is the default on every experiment: spans
reduce to a no-op context manager, nothing is emitted, no clock is read
and no counter snapshot taken, but the round/span counters still advance
so checkpoints can persist trace continuity (``state``/``from_state`` — a
restored run appends to the same JSONL trace instead of restarting its
numbering).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import time
import uuid
from typing import Optional

from repro_torch.obs import counters

EVENT_TYPES = ("run_start", "span", "round", "client_dropped",
               "client_join", "client_leave", "anytime_eval")
DROP_REASONS = ("dropout", "max_staleness", "client_left", "algo_swap")

# canonical phase names; the sync runtime's "update" span wraps the whole
# round call, with the layers inside it nested: "local_update" (the
# cohort's K local steps and the upload encode), "soap_refresh" (SOAP's
# scheduled eigenbasis refresh), "encode" (the wire codecs), "aggregate"
# (the server's flush) and "telemetry" (``obs.telemetry.collect``).
# Population staging splits into "stage_batches" + "state_acquire"; the
# chunk-streaming pipeline (fed.pipeline) emits per-chunk "chunk_stage" /
# "chunk_restore" / "chunk_compute" spans (carrying a ``chunk`` index)
# and reuses "flush" for the blocking finish step.
PHASES = ("staging", "stage_batches", "state_acquire", "local_update",
          "update", "chunk_stage", "chunk_restore", "chunk_compute",
          "flush", "eval", "soap_refresh", "encode", "aggregate",
          "telemetry")


class Tracer:
    """Stamps, counts, and fans out trace events to sinks."""

    def __init__(self, sinks=(), run_id: Optional[str] = None, *,
                 rounds: int = 0, spans: int = 0, seq: int = 0,
                 clock=time.perf_counter):
        self.sinks = tuple(sinks)
        self.run_id = run_id if run_id is not None else uuid.uuid4().hex[:12]
        self.rounds = rounds       # cumulative round events (checkpointed)
        self.spans = spans         # cumulative spans (checkpointed)
        self.seq = seq
        self._clock = clock
        self._next_id = spans      # span ids continue a restored trace
        self._round_start = None   # counters at the open round's start

    @property
    def enabled(self) -> bool:
        return bool(self.sinks)

    # ------------------------------------------------------------ emission

    def emit(self, event_type: str, **fields) -> dict:
        ev = {"event": event_type, "run_id": self.run_id, "seq": self.seq}
        ev.update(fields)
        self.seq += 1
        for s in self.sinks:
            s.emit(ev)
        return ev

    @contextlib.contextmanager
    def activate(self):
        """Make this tracer ``current()`` for the block (a round, a
        dispatch, a flush); an enabled tracer with no round open opens one
        here, snapshotting ``obs.counters``."""
        if self.sinks and self._round_start is None:
            self._round_start = counters.snapshot()
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)

    @contextlib.contextmanager
    def span(self, phase: str, *, round: Optional[int] = None,
             client_id: Optional[int] = None, chunk: Optional[int] = None,
             sim_time: Optional[float] = None):
        """Record one phase; emits a ``span`` event with the wall duration,
        the epoch stamps, its id and the id of the enclosing span.

        Disabled tracers skip the clock reads entirely — instrumented code
        paths cost nothing when nobody is listening."""
        if not self.sinks:
            yield
            self.spans += 1
            return
        stack = _OPEN.get()
        parent = stack[-1] if stack and stack[-1][0] is self else None
        if round is None and parent is not None:
            round = parent[2]
        sid = self._next_id
        self._next_id += 1
        token = _OPEN.set(stack + ((self, sid, round),))
        t0_ns = time.time_ns()
        t0 = self._clock()
        try:
            yield
        finally:
            dur = self._clock() - t0
            t1_ns = time.time_ns()
            _OPEN.reset(token)
            self.spans += 1
            fields = {"phase": phase, "dur_s": dur, "t0_ns": t0_ns,
                      "t1_ns": t1_ns, "id": sid}
            if parent is not None:
                fields["parent"] = parent[1]
            if round is not None:
                fields["round"] = int(round)
            if client_id is not None:
                fields["client_id"] = int(client_id)
            if chunk is not None:
                fields["chunk"] = int(chunk)
            if sim_time is not None:
                fields["sim_time"] = float(sim_time)
            self.emit("span", **fields)

    def round_event(self, r: int, metrics: dict, *,
                    telemetry: Optional[dict] = None,
                    sim_time: Optional[float] = None) -> None:
        self.rounds += 1
        if not self.sinks:
            return
        fields = {"round": int(r), "metrics": metrics}
        if telemetry is not None:
            fields["telemetry"] = telemetry
        if sim_time is not None:
            fields["sim_time"] = float(sim_time)
        if self._round_start is not None:
            fields["counters"] = counters.delta(self._round_start,
                                                counters.snapshot())
            self._round_start = None
            counters.record_traced_round(fields["counters"])
        self.emit("round", **fields)

    def client_dropped(self, client_id: int, *, reason: str, version: int,
                       sim_time: Optional[float] = None) -> None:
        if not self.sinks:
            return
        if reason not in DROP_REASONS:
            raise ValueError(f"unknown drop reason {reason!r} "
                             f"(want one of {DROP_REASONS})")
        fields = {"client_id": int(client_id), "reason": reason,
                  "version": int(version)}
        if sim_time is not None:
            fields["sim_time"] = float(sim_time)
        self.emit("client_dropped", **fields)

    def client_join(self, client_id: int, *,
                    sim_time: Optional[float] = None) -> None:
        """Churn: ``client_id`` joined the active population."""
        if not self.sinks:
            return
        fields = {"client_id": int(client_id)}
        if sim_time is not None:
            fields["sim_time"] = float(sim_time)
        self.emit("client_join", **fields)

    def client_leave(self, client_id: int, *, in_flight: bool = False,
                     sim_time: Optional[float] = None) -> None:
        """Churn: ``client_id`` left; ``in_flight`` says whether its pending
        dispatch was voided (that work surfaces later as a
        ``client_dropped`` with reason ``"client_left"``)."""
        if not self.sinks:
            return
        fields = {"client_id": int(client_id), "in_flight": bool(in_flight)}
        if sim_time is not None:
            fields["sim_time"] = float(sim_time)
        self.emit("client_leave", **fields)

    def anytime_eval(self, metrics: dict, *, sim_time: float,
                     round: Optional[int] = None) -> None:
        """Online eval sampled by simulated time (continuous traffic)."""
        if not self.sinks:
            return
        fields = {"metrics": metrics, "sim_time": float(sim_time)}
        if round is not None:
            fields["round"] = int(round)
        self.emit("anytime_eval", **fields)

    # ------------------------------------------------------- checkpointing

    def state(self) -> dict:
        """Persistent trace identity: stash in checkpoint meta so a
        restored run appends to the same trace without renumbering."""
        return {"run_id": self.run_id, "rounds": self.rounds,
                "spans": self.spans, "seq": self.seq}

    @classmethod
    def from_state(cls, state: Optional[dict], sinks=()) -> "Tracer":
        if not state:
            return cls(sinks=sinks)
        return cls(sinks=sinks, run_id=state["run_id"],
                   rounds=state.get("rounds", 0),
                   spans=state.get("spans", 0), seq=state.get("seq", 0))


NULL_TRACER = Tracer()   # shared disabled default; counters unused
_CURRENT = contextvars.ContextVar("repro_torch_tracer", default=NULL_TRACER)
# the enabled spans open in this context, innermost last:
# (tracer, id, round)
_OPEN = contextvars.ContextVar("repro_torch_open_spans", default=())


def current() -> Tracer:
    """The tracer a runtime made current (``Tracer.activate``) around the
    running round, dispatch or flush; ``NULL_TRACER`` elsewhere."""
    return _CURRENT.get()


def activating(method):
    """Decorate an experiment's method to run with ``self.tracer``
    current (``Tracer.activate``)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self.tracer.activate():
            return method(self, *args, **kwargs)
    return run


# ---------------------------------------------------------------- schema

_REQUIRED = {
    "span": ("phase", "dur_s"),
    "round": ("round", "metrics"),
    "client_dropped": ("client_id", "reason", "version"),
    "client_join": ("client_id",),
    "client_leave": ("client_id", "in_flight"),
    "anytime_eval": ("metrics", "sim_time"),
    "run_start": (),
}


def validate_event(ev: dict) -> None:
    """Raise ``ValueError`` unless ``ev`` matches the trace schema."""
    if not isinstance(ev, dict):
        raise ValueError(f"trace event must be a dict, got {type(ev)}")
    for key in ("event", "run_id", "seq"):
        if key not in ev:
            raise ValueError(f"trace event missing {key!r}: {ev}")
    kind = ev["event"]
    if kind not in EVENT_TYPES:
        raise ValueError(
            f"unknown trace event type {kind!r} (want one of {EVENT_TYPES})")
    for field in _REQUIRED[kind]:
        if field not in ev:
            raise ValueError(f"{kind} event missing {field!r}: {ev}")
    if kind == "client_dropped" and ev["reason"] not in DROP_REASONS:
        raise ValueError(f"bad drop reason {ev['reason']!r}")
    if not isinstance(ev["seq"], int):
        raise ValueError(f"seq must be an int, got {ev['seq']!r}")
    for key in ("t0_ns", "t1_ns", "id", "parent"):
        if key in ev and not isinstance(ev[key], int):
            raise ValueError(f"{key} must be an int, got {ev[key]!r}")
    if "t0_ns" in ev and "t1_ns" in ev and ev["t0_ns"] > ev["t1_ns"]:
        raise ValueError(f"span ends before it starts: {ev}")


def validate_jsonl(path: str) -> int:
    """Validate every line of a JSONL trace; returns the event count."""
    import json
    n = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            validate_event(json.loads(line))
            n += 1
    if n == 0:
        raise ValueError(f"empty trace {path!r}")
    return n
