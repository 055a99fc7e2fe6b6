"""Arrival-rate processes and churn models for continuous-traffic replay
(counterpart of ``repro/fed/traffic/traces.py``, copied: numpy only, so the
same seed gives the reference's arrival and churn draws bit for bit).

An :class:`ArrivalProcess` answers one question — *when does the next
client arrive?* — via ``next_arrival(t)``.  Arrivals are simulated-time
points at which one client is dispatched into the scheduler's bounded
in-flight pool (if the pool is full the arrival is deferred until a
completion frees a slot, modelling an admission queue).  All processes are
Poisson-thinned from a rate function ``rate(t)`` with a per-process
``np.random.Generator`` that is **separate** from the scheduler's selection
stream, so swapping trace shapes never perturbs which clients are chosen
at a given arrival instant.

Catalog
-------

* :class:`ConstantRate` — homogeneous Poisson at ``rate`` arrivals per
  simulated second.  ``rate=float('inf')`` is the *saturating* regime: the
  pool is refilled the instant a slot frees, which reproduces the legacy
  round-shaped async runtime exactly (the parity test pins this).
* :class:`DiurnalRate` — sinusoidal day/night cycle,
  ``base * (1 + amplitude * sin(2*pi*(t/period + phase)))``.
* :class:`BurstyRate` — self-exciting Hawkes process (Ogata thinning):
  every arrival bumps the intensity by ``jump``, decaying at ``decay``.
* :class:`PiecewiseRate` — rate replayed from an empirical array (one
  entry per ``bin_width`` seconds of trace), the "replay a measured
  traffic trace" hook.

Each process checkpoints with ``state()/load_state()`` (its rng bit
generator plus any scalar intensity state) so a mid-stream restore
continues the exact arrival sequence.

Churn
-----

:class:`ChurnConfig` + :class:`Membership` model clients joining and
leaving the population as two independent Poisson streams over the id
space.  A departure evicts the client's persistent state (LRU slot /
spill file) and voids its in-flight work — the completion still pops (its
simulated time passes) but the payload is discarded with a traced
``client_dropped`` reason ``"client_left"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

_HUGE = float("inf")


class ArrivalProcess:
    """Base: thinning over ``rate(t)`` bounded by ``rate_bound(t, ...)``."""

    #: processes whose intensity depends on past arrivals (Hawkes) need to
    #: be told when an arrival was *accepted*; the runtime calls this.
    self_exciting = False

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(int(seed))

    def rate(self, t: float) -> float:            # pragma: no cover
        raise NotImplementedError

    def rate_bound(self, t: float) -> float:
        """An upper bound on ``rate`` over ``[t, inf)`` — the thinning
        envelope.  Defaults to a constant global bound."""
        raise NotImplementedError

    def next_arrival(self, t: float) -> float:
        """Simulated time of the first arrival strictly after ``t``."""
        lam_max = float(self.rate_bound(t))
        if lam_max <= 0.0:
            return _HUGE
        if math.isinf(lam_max):
            return t                   # saturating: an arrival is always due
        while True:
            t = t + self.rng.exponential(1.0 / lam_max)
            # one uniform per candidate keeps the stream aligned even when
            # rate == bound (constant rate): accept-with-prob-1 still draws
            u = self.rng.uniform()
            lam = float(self.rate(t))
            if u * lam_max <= lam:
                return t
            lam_max = float(self.rate_bound(t))

    def notify_arrival(self, t: float) -> None:
        """Hook for self-exciting processes; default is a no-op."""

    # ------------------------------------------------------- checkpointing

    def state(self) -> dict:
        return {"rng": self.rng.bit_generator.state}

    def load_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]


class ConstantRate(ArrivalProcess):
    """Homogeneous Poisson arrivals; ``rate=inf`` saturates the pool."""

    def __init__(self, rate: float, seed: int = 0):
        super().__init__(seed)
        if not (rate > 0.0):
            raise ValueError(f"arrival rate must be > 0, got {rate}")
        self._rate = float(rate)

    @property
    def saturating(self) -> bool:
        return math.isinf(self._rate)

    def rate(self, t: float) -> float:
        return self._rate

    def rate_bound(self, t: float) -> float:
        return self._rate


class DiurnalRate(ArrivalProcess):
    """Sinusoidal day/night cycle around a base rate."""

    def __init__(self, base: float, amplitude: float = 0.8,
                 period: float = 24.0, phase: float = 0.0, seed: int = 0):
        super().__init__(seed)
        if base <= 0 or not math.isfinite(base):
            raise ValueError(f"base rate must be finite > 0, got {base}")
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1] (rate stays >= 0), "
                f"got {amplitude}")
        if period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        self.base = float(base)
        self.amplitude = float(amplitude)
        self.period = float(period)
        self.phase = float(phase)

    def rate(self, t: float) -> float:
        return self.base * (1.0 + self.amplitude * math.sin(
            2.0 * math.pi * (t / self.period + self.phase)))

    def rate_bound(self, t: float) -> float:
        return self.base * (1.0 + self.amplitude)


class BurstyRate(ArrivalProcess):
    """Self-exciting Hawkes process: bursts feed on themselves.

    Intensity ``lam(t) = base + excitation * exp(-decay * (t - t_last))``
    where every accepted arrival adds ``jump`` to the excitation.  The
    stationarity condition ``jump / decay < 1`` is enforced so the process
    cannot run away.
    """

    self_exciting = True

    def __init__(self, base: float, jump: float = 0.5, decay: float = 1.0,
                 seed: int = 0):
        super().__init__(seed)
        if base <= 0 or not math.isfinite(base):
            raise ValueError(f"base rate must be finite > 0, got {base}")
        if jump < 0 or decay <= 0:
            raise ValueError(f"need jump >= 0, decay > 0 "
                             f"(got jump={jump}, decay={decay})")
        if jump / decay >= 1.0:
            raise ValueError(
                f"non-stationary Hawkes: jump/decay = {jump / decay:.3f} "
                ">= 1 (each arrival spawns >= 1 expected child)")
        self.base = float(base)
        self.jump = float(jump)
        self.decay = float(decay)
        self._excitation = 0.0         # excess intensity at _last_t
        self._last_t = 0.0

    def _excitation_at(self, t: float) -> float:
        return self._excitation * math.exp(
            -self.decay * max(0.0, t - self._last_t))

    def rate(self, t: float) -> float:
        return self.base + self._excitation_at(t)

    def rate_bound(self, t: float) -> float:
        # intensity only decays between arrivals: current value bounds it
        return self.base + self._excitation_at(t)

    def notify_arrival(self, t: float) -> None:
        self._excitation = self._excitation_at(t) + self.jump
        self._last_t = float(t)

    def state(self) -> dict:
        return {"rng": self.rng.bit_generator.state,
                "excitation": self._excitation, "last_t": self._last_t}

    def load_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self._excitation = float(state["excitation"])
        self._last_t = float(state["last_t"])


class PiecewiseRate(ArrivalProcess):
    """Rate replayed from an empirical array — one entry per ``bin_width``
    simulated seconds.  Past the last bin the trace wraps (``cycle=True``,
    the default) or holds its final value."""

    def __init__(self, rates, bin_width: float = 1.0, cycle: bool = True,
                 seed: int = 0):
        super().__init__(seed)
        rates = np.asarray(rates, np.float64).ravel()
        if rates.size == 0 or rates.min() < 0 or not np.isfinite(rates).all():
            raise ValueError("rates must be a non-empty array of finite "
                             "values >= 0")
        if rates.max() <= 0:
            raise ValueError("rates are identically zero: no arrivals ever")
        if bin_width <= 0:
            raise ValueError(f"bin_width must be > 0, got {bin_width}")
        self.rates = rates
        self.bin_width = float(bin_width)
        self.cycle = bool(cycle)

    def rate(self, t: float) -> float:
        i = int(math.floor(float(t) / self.bin_width))
        n = self.rates.size
        i = i % n if self.cycle else min(max(i, 0), n - 1)
        return float(self.rates[i])

    def rate_bound(self, t: float) -> float:
        if self.cycle:
            return float(self.rates.max())
        i = int(math.floor(float(t) / self.bin_width))
        i = min(max(i, 0), self.rates.size - 1)
        return float(self.rates[i:].max())


TRACES = ("constant", "diurnal", "bursty", "piecewise")


def make_trace(kind: str, seed: int = 0, **kwargs) -> ArrivalProcess:
    """Trace factory by name — what configs and the bench sweep use."""
    if kind == "constant":
        return ConstantRate(seed=seed, **kwargs)
    if kind == "diurnal":
        return DiurnalRate(seed=seed, **kwargs)
    if kind == "bursty":
        return BurstyRate(seed=seed, **kwargs)
    if kind == "piecewise":
        return PiecewiseRate(seed=seed, **kwargs)
    raise ValueError(f"unknown trace kind {kind!r} (want one of {TRACES})")


# ---------------------------------------------------------------- churn


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Client join/leave dynamics over the population id space.

    ``join_rate`` / ``leave_rate`` are Poisson rates (events per simulated
    second); ``initial_active`` caps how many ids start active (None =
    whole population).  Zero rates with ``initial_active=None`` is the
    no-churn degenerate case (every id always active)."""
    join_rate: float = 0.0
    leave_rate: float = 0.0
    initial_active: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.join_rate < 0 or self.leave_rate < 0:
            raise ValueError("churn rates must be >= 0")

    @property
    def active(self) -> bool:
        return (self.join_rate > 0 or self.leave_rate > 0
                or self.initial_active is not None)


class Membership:
    """The active subset of a population id space under churn.

    Joins draw uniformly from the inactive ids, leaves uniformly from the
    active ones; both consume this object's own generator so churn noise
    never shifts the scheduler's selection or latency streams.  The whole
    structure (sets + rng) round-trips through ``state()/load_state``.
    """

    def __init__(self, population_size: int, churn: ChurnConfig):
        self.population_size = int(population_size)
        self.churn = churn
        self.rng = np.random.default_rng(int(churn.seed))
        n0 = population_size if churn.initial_active is None \
            else min(int(churn.initial_active), population_size)
        if n0 < 1:
            raise ValueError(f"initial_active must be >= 1, got {n0}")
        if n0 == population_size:
            active = np.arange(population_size, dtype=np.int64)
        else:
            active = self.rng.choice(population_size, size=n0, replace=False)
        self._active: set = {int(c) for c in active}
        self.joins = 0
        self.leaves = 0

    @property
    def n_active(self) -> int:
        return len(self._active)

    def is_active(self, cid: int) -> bool:
        return int(cid) in self._active

    def active_ids(self) -> np.ndarray:
        return np.fromiter(sorted(self._active), np.int64,
                           count=len(self._active))

    def next_event(self, t: float):
        """``(time, kind)`` of the next churn event after ``t`` — kind is
        ``"join"`` or ``"leave"`` — or ``(inf, None)`` without churn rates.
        Competing exponentials: one draw for the merged stream, one to
        attribute it."""
        jr = self.churn.join_rate if len(self._active) < \
            self.population_size else 0.0
        lr = self.churn.leave_rate if len(self._active) > 1 else 0.0
        total = jr + lr
        if total <= 0:
            return _HUGE, None
        dt = self.rng.exponential(1.0 / total)
        kind = "join" if self.rng.uniform() * total < jr else "leave"
        return t + dt, kind

    def sample_join(self) -> Optional[int]:
        """Activate one uniformly-drawn inactive id (None if all active)."""
        n_inactive = self.population_size - len(self._active)
        if n_inactive <= 0:
            return None
        # rank-based draw over the complement — no dense materialization
        k = int(self.rng.integers(n_inactive))
        cid = self._kth_inactive(k)
        self._active.add(cid)
        self.joins += 1
        return cid

    def _kth_inactive(self, k: int) -> int:
        act = sorted(self._active)
        lo = 0
        for a in act:
            gap = a - lo              # inactive ids in [lo, a)
            if k < gap:
                return lo + k
            k -= gap
            lo = a + 1
        return lo + k

    def sample_leave(self) -> Optional[int]:
        """Deactivate one uniformly-drawn active id (None if <= 1 left)."""
        if len(self._active) <= 1:
            return None
        ids = self.active_ids()
        cid = int(ids[self.rng.integers(len(ids))])
        self._active.discard(cid)
        self.leaves += 1
        return cid

    def sample_dispatch(self, rng: np.random.Generator,
                        exclude: set) -> Optional[int]:
        """One uniformly-drawn active id outside ``exclude`` — consumes the
        *scheduler's* generator (selection stream), not the churn one.
        None when churn shrank the idle active set to nothing (the arrival
        queues until a join or a completion frees a candidate)."""
        ids = self.active_ids()
        if exclude:
            ids = ids[~np.isin(ids, np.fromiter(
                (int(c) for c in exclude), np.int64, count=len(exclude)))]
        if len(ids) == 0:
            return None
        return int(ids[rng.integers(len(ids))])

    # ------------------------------------------------------- checkpointing

    def state(self) -> dict:
        return {"active": [int(c) for c in sorted(self._active)],
                "rng": self.rng.bit_generator.state,
                "joins": self.joins, "leaves": self.leaves}

    def load_state(self, state: dict) -> None:
        self._active = {int(c) for c in state["active"]}
        self.rng.bit_generator.state = state["rng"]
        self.joins = int(state["joins"])
        self.leaves = int(state["leaves"])
