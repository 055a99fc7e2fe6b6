"""Client latency / availability models for the simulated-time scheduler
(counterpart of ``repro/fed/async_runtime/latency.py``, copied:
numpy only).

Two-level heterogeneity, matching production FL traces:
  * persistent per-client speed: each client draws a lognormal multiplier
    with sigma = ``heterogeneity`` once (slow phones stay slow);
  * per-round jitter: every dispatch draws a fresh latency from
    ``distribution`` scaled by the client's speed.
``dropout`` is the probability a dispatched client never reports back (the
simulated wall-clock is still spent).  All draws come from the scheduler's
seeded ``np.random.Generator``, so event order is deterministic per seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# domain-separation tag for per-id derived speeds (population mode)
_SPEED_TAG = 0x5BEED


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    distribution: str = "lognormal"   # lognormal | exponential | uniform | pareto
    mean_latency: float = 1.0         # seconds of simulated time
    jitter: float = 0.25              # per-draw spread (sigma / half-width)
    heterogeneity: float = 0.0        # sigma of persistent per-client speed
    dropout: float = 0.0              # P(result never arrives)
    pareto_shape: float = 2.5

    def client_speeds(self, n_clients: int, rng: np.random.Generator):
        """Persistent per-client latency multipliers (1.0 when homogeneous)."""
        if self.heterogeneity <= 0.0:
            return np.ones(n_clients)
        # median-1 lognormal: half the fleet faster, half slower
        return np.exp(rng.normal(0.0, self.heterogeneity, size=n_clients))

    def client_speed(self, seed: int, client_id: int) -> float:
        """One client's persistent speed, derived from its global id alone
        (population mode): ``SeedSequence((seed, tag, client_id))`` — the
        same multiplier whether the id space holds 10^2 or 10^6 clients,
        with no dense speeds array."""
        if self.heterogeneity <= 0.0:
            return 1.0
        rng = np.random.default_rng(
            np.random.SeedSequence((int(seed), _SPEED_TAG, int(client_id))))
        return float(np.exp(rng.normal(0.0, self.heterogeneity)))

    def sample_latency(self, speed: float, rng: np.random.Generator) -> float:
        d = self.distribution
        if d == "lognormal":
            base = self.mean_latency * np.exp(
                rng.normal(0.0, self.jitter) - 0.5 * self.jitter**2)
        elif d == "exponential":
            base = rng.exponential(self.mean_latency)
        elif d == "uniform":
            half = self.jitter * self.mean_latency
            base = rng.uniform(self.mean_latency - half,
                               self.mean_latency + half)
        elif d == "pareto":
            a = self.pareto_shape
            base = self.mean_latency * (a - 1.0) / a * (1.0 + rng.pareto(a))
        else:
            raise ValueError(f"unknown latency distribution {d!r}")
        return float(max(base * speed, 1e-9))

    def sample_dropout(self, rng: np.random.Generator) -> bool:
        return bool(self.dropout > 0.0 and rng.uniform() < self.dropout)
