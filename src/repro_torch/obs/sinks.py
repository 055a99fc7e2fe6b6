"""Pluggable telemetry sinks: where round metrics and trace events go
(counterpart of ``repro/obs/sinks.py``).

One protocol (``Sink.emit(event: dict)``) serves both the per-round metric
hook (``FedExperiment.log_round``) and the structured round-trace stream
(``obs.trace.Tracer``).  Events are plain dicts — JSON-serializable except
for the values a custom eval fn may put into round metrics, which
``JsonlSink`` coerces defensively.

  StdoutRoundSink  default ``log_round`` sink; prints round metrics with
                   exactly the legacy formatting (``format_metric``), so
                   routing logging through the protocol changes no output.
  JsonlSink        one JSON object per line, flushed per event (a crashed
                   run keeps its trace up to the last completed event).
  CsvSink          round events flattened to CSV rows (header from the
                   first event; spans/drops are skipped).
  MemorySink       in-memory list, for tests and notebook analysis.
"""
from __future__ import annotations

import json
import os
from typing import Optional


def format_metric(v):
    """4-decimal rounding for floats; everything else (ints, None, strings,
    arrays from custom eval fns) passes through untouched."""
    try:
        return round(v, 4)
    except TypeError:
        return v


class Sink:
    """``emit`` one event dict; ``close`` flushes/releases resources."""

    def emit(self, event: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class StdoutRoundSink(Sink):
    """Legacy-bitwise stdout logging of round events.

    Prints ``{metric: format_metric(value)}`` for ``event="round"`` and
    ignores everything else — byte-identical to the pre-sink
    ``FedExperiment.log_round`` output, including the defensive
    non-float path.
    """

    def emit(self, event: dict) -> None:
        if event.get("event") != "round":
            return
        print({k: format_metric(v) for k, v in event["metrics"].items()})


class MemorySink(Sink):
    """Accumulates events in ``self.events`` (tests, notebooks)."""

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(dict(event))

    def rounds(self) -> list[dict]:
        return [e for e in self.events if e.get("event") == "round"]


def _jsonable(v):
    """Best-effort coercion for eval-fn values: tensors and numpy arrays
    (0-d ones and numpy scalars become Python numbers)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "tolist"):          # tensors, numpy arrays and scalars
        return _jsonable(v.tolist())
    return repr(v)


class JsonlSink(Sink):
    """One event per line; opened lazily, flushed per event."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self._mode = "a" if append else "w"
        self._f = None

    def _file(self):
        if self._f is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._f = open(self.path, self._mode)
        return self._f

    def emit(self, event: dict) -> None:
        f = self._file()
        f.write(json.dumps(_jsonable(event)) + "\n")
        f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class CsvSink(Sink):
    """Round events as CSV rows; column set fixed by the first round event.

    Scalar metric/telemetry fields become columns (telemetry vectors and
    non-round events are skipped — use ``JsonlSink`` for the full stream).
    """

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._cols: Optional[list] = None

    def _flat(self, event: dict) -> dict:
        row = {"round": event.get("round")}
        for src in ("metrics", "telemetry"):
            for k, v in (event.get(src) or {}).items():
                if isinstance(v, (bool, int, float)) or v is None:
                    row[k] = v
        return row

    def emit(self, event: dict) -> None:
        if event.get("event") != "round":
            return
        row = self._flat(event)
        if self._f is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "w")
            self._cols = list(row)
            self._f.write(",".join(self._cols) + "\n")
        vals = [row.get(c) for c in self._cols]
        self._f.write(",".join("" if v is None else str(v)
                               for v in vals) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
