"""Shared federated-experiment interface (counterpart of
``repro/fed/base.py``).

``FedExperiment`` is the runtime-agnostic contract that both the
lock-step synchronous runtime (``fed.rounds.FederatedExperiment``) and the
buffered asynchronous runtime (``fed.async_runtime
.AsyncFederatedExperiment``) implement.  One ``run_round()`` is one server
model update — a communication round in the sync runtime, a buffer flush
in the async one.  Round logging goes through the overridable
``log_round`` hook, which emits one ``round`` event into ``self.sink``
(default ``StdoutRoundSink``: the reference's print formatting).
``self.tracer`` is the round-trace span recorder (disabled until sinks
are attached via ``repro_torch.obs.attach``).

``make_experiment`` picks the runtime from ``FedConfig.runtime`` — the
legacy positional constructor; prefer ``repro_torch.api.build_experiment``.
"""
from __future__ import annotations

import abc
from typing import Optional

from repro_torch.obs.sinks import StdoutRoundSink
from repro_torch.obs.sinks import format_metric as _format_metric
from repro_torch.obs.trace import Tracer


class FedExperiment(abc.ABC):
    """Drives server model updates for any algorithm over client datasets.

      fed      — the experiment config; must expose an int ``rounds``
      history  — list of per-round metric dicts, appended by run_round()
      scenario — the materialized ``Scenario`` bundle when built from a
                 declarative scenario; None otherwise
      sink     — ``repro_torch.obs.Sink`` receiving ``log_round`` events
      tracer   — ``repro_torch.obs.Tracer`` for span/round/drop events;
                 disabled (no sinks) unless ``obs.attach``-ed
      last_telemetry — the most recent ``Telemetry`` (None before the
                 first round)
    """

    scenario = None      # set by repro_torch.api.build_experiment

    def __init__(self, fed):
        rounds = getattr(fed, "rounds", None)
        if not isinstance(rounds, int) or isinstance(rounds, bool):
            raise TypeError(
                "FedExperiment config must expose an integer 'rounds' "
                f"attribute (got {type(fed).__name__} with "
                f"rounds={rounds!r})")
        self.fed = fed
        self.history = []
        self.sink = StdoutRoundSink()
        self.tracer = Tracer()       # disabled until obs.attach()
        self.last_telemetry = None

    @abc.abstractmethod
    def run_round(self) -> dict:
        """Advance the server by one model update; returns the metrics row."""

    @abc.abstractmethod
    def comm_bytes_per_round(self) -> int:
        """Per-client upload bytes for one round (Table 6 accounting)."""

    format_metric = staticmethod(_format_metric)

    def log_round(self, rec: dict, r: int) -> None:
        """Per-round logging hook; routes through ``self.sink``."""
        self.sink.emit({"event": "round", "run_id": self.tracer.run_id,
                        "round": r, "metrics": rec})

    def run(self, rounds: Optional[int] = None, log_every: int = 0):
        """Run ``rounds`` model updates (default: ``self.fed.rounds``)."""
        for r in range(rounds if rounds is not None else self.fed.rounds):
            rec = self.run_round()
            if log_every and (r % log_every == 0):
                self.log_round(rec, r)
        return self.history


def make_experiment(fed, params, loss_fn, client_batch_fn, eval_fn=None,
                    opt_kwargs=None, async_cfg=None) -> FedExperiment:
    """Instantiate the runtime named by ``fed.runtime`` ("sync" | "async")."""
    if fed.runtime == "sync":
        if async_cfg is not None:
            raise ValueError(
                "async_cfg given but fed.runtime='sync' — set "
                "FedConfig(runtime='async') or drop the async_cfg")
        from repro_torch.fed.rounds import FederatedExperiment
        return FederatedExperiment(fed, params, loss_fn, client_batch_fn,
                                   eval_fn, opt_kwargs)
    if fed.runtime == "async":
        from repro_torch.fed.async_runtime import AsyncFederatedExperiment
        return AsyncFederatedExperiment(fed, params, loss_fn, client_batch_fn,
                                        eval_fn, opt_kwargs,
                                        async_cfg=async_cfg)
    raise ValueError(f"unknown runtime {fed.runtime!r} (want 'sync'|'async')")
