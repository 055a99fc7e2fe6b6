"""Shared federated-experiment interface (counterpart of
``repro/fed/base.py``, without tracer or sinks).

One ``run_round()`` is one server model update.  ``log_round`` prints the
round's metrics with floats rounded to 4 decimals, as the reference's
default stdout sink does.
"""
from __future__ import annotations

import abc
from typing import Optional


def format_metric(v):
    """4-decimal rounding for floats; everything else passes through."""
    try:
        return round(v, 4)
    except TypeError:
        return v


class FedExperiment(abc.ABC):
    """Drives server model updates for any algorithm over client datasets.

      fed      — the experiment config; must expose an int ``rounds``
      history  — list of per-round metric dicts, appended by run_round()
      scenario — the materialized ``Scenario`` bundle when built from a
                 declarative scenario; None otherwise
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

    @abc.abstractmethod
    def run_round(self) -> dict:
        """Advance the server by one model update; returns the metrics row."""

    @abc.abstractmethod
    def comm_bytes_per_round(self) -> int:
        """Per-client upload bytes for one round (Table 6 accounting)."""

    def log_round(self, rec: dict, r: int) -> None:
        del r
        print({k: format_metric(v) for k, v in rec.items()})

    def run(self, rounds: Optional[int] = None, log_every: int = 0):
        """Run ``rounds`` model updates (default: ``self.fed.rounds``)."""
        for r in range(rounds if rounds is not None else self.fed.rounds):
            rec = self.run_round()
            if log_every and (r % log_every == 0):
                self.log_round(rec, r)
        return self.history
