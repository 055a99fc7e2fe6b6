"""Client directory over an abstract id space (counterpart of
``repro/fed/population/directory.py``; numpy only).

A ``ClientPopulation`` is the id space ``[0, size)`` plus a streaming
``CohortSampler``: cohorts are drawn, never enumerated, so a 10^6-client
population costs O(cohort) work and memory per round.

Cohorts (``SeedSequence((seed, tag, round))``), batch-staging generators
(``client_rng``: ``SeedSequence((seed, tag, client_id, salt))``) and the
samplers are the reference's, so they draw the same ids and batches bit
for bit.  ``client_key`` cannot be the reference's ``jax.random.fold_in``
key: it is one integer seed per client and salt from a ``SeedSequence``
of its own, which seeds that client's ``torch.Generator`` (Sophia's
probes).  Every per-client draw is invariant to the population size and
to the cohort it rides in.

The legacy dense-list path (``FedConfig.population_size is None``) does
not run through this module.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

# domain-separation tags for the SeedSequence streams (arbitrary, fixed;
# the cohort and client tags are the reference's)
_COHORT_TAG = 0xC0607
_CLIENT_TAG = 0xC11E57
_KEY_TAG = 0x5EEDC1
_MAX_REJECT_ROUNDS = 64


def _distinct_uniform(rng: np.random.Generator, size: int, k: int,
                      exclude=frozenset()) -> np.ndarray:
    """``k`` distinct ids from ``[0, size)`` minus ``exclude`` in O(k) memory.

    Small id spaces take the exact permutation route; large ones
    rejection-sample (the regime where k << size, so collisions are rare).
    """
    avail = size - len(exclude)
    if k > avail:
        raise ValueError(
            f"cannot draw {k} distinct clients from an id space of {size} "
            f"with {len(exclude)} excluded")
    if size <= max(4 * k, 1024) + len(exclude):
        pool = np.arange(size)
        if exclude:
            pool = pool[~np.isin(pool, np.fromiter(exclude, np.int64,
                                                   len(exclude)))]
        return rng.permutation(pool)[:k]
    chosen: list = []
    seen = set(exclude)
    for _ in range(_MAX_REJECT_ROUNDS):
        draw = rng.integers(0, size, size=2 * (k - len(chosen)) + 8)
        for cid in draw:
            c = int(cid)
            if c not in seen:
                seen.add(c)
                chosen.append(c)
                if len(chosen) == k:
                    return np.asarray(chosen, np.int64)
    raise RuntimeError(    # pragma: no cover — k << size makes this unreachable
        f"rejection sampling failed to find {k} distinct ids in {size}")


class UniformSampler:
    """Uniform cohort draws without replacement, streaming."""

    def sample(self, rng: np.random.Generator, size: int, k: int, *,
               t: float = 0) -> np.ndarray:
        del t
        return _distinct_uniform(rng, size, k)


class WeightedSampler:
    """Weight-proportional cohorts via Gumbel top-k over a candidate pool.

    ``weight_fn(ids) -> (len(ids),) nonnegative weights`` is evaluated only
    on sampled candidates, never on the full population.  Id spaces small
    enough to enumerate (<= ``exact_below``) are sampled exactly; larger
    ones draw a uniform candidate pool of ``oversample * k`` ids first, so
    the draw is weight-proportional *within the pool* — an approximation
    whose bias shrinks as ``oversample`` grows.
    """

    def __init__(self, weight_fn: Callable[[np.ndarray], np.ndarray],
                 oversample: int = 16, exact_below: int = 65536):
        if oversample < 2:
            raise ValueError(f"oversample must be >= 2, got {oversample}")
        self.weight_fn = weight_fn
        self.oversample = int(oversample)
        self.exact_below = int(exact_below)

    def sample(self, rng: np.random.Generator, size: int, k: int, *,
               t: float = 0) -> np.ndarray:
        del t
        if k > size:
            raise ValueError(f"cohort {k} exceeds population {size}")
        if size <= max(self.exact_below, self.oversample * k):
            cand = np.arange(size)
        else:
            cand = _distinct_uniform(rng, size, self.oversample * k)
        w = np.asarray(self.weight_fn(cand), np.float64)
        if w.shape != cand.shape:
            raise ValueError(
                f"weight_fn returned shape {w.shape} for {cand.shape} ids")
        if np.any(w < 0) or not np.any(w > 0):
            raise ValueError("weights must be nonnegative with at least "
                             f"{k} strictly positive entries")
        if int(np.sum(w > 0)) < k:
            raise ValueError(
                f"only {int(np.sum(w > 0))} candidates have positive weight "
                f"but the cohort needs {k}")
        # Gumbel top-k == sequential weighted sampling without replacement
        with np.errstate(divide="ignore"):
            keys = np.where(w > 0, np.log(w), -np.inf) + rng.gumbel(
                size=w.shape)
        return cand[np.argsort(-keys, kind="stable")[:k]].astype(np.int64)


def _mix_u01(ids: np.ndarray, hour: int) -> np.ndarray:
    """Deterministic per-(id, hour) uniforms in [0, 1) — a cheap integer
    hash (splitmix-style multiply/xor), invariant to population size and
    to evaluation order, so fractional availability tables resolve to a
    stable per-client on/off decision each hour."""
    x = (np.asarray(ids, np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + np.uint64(hour) * np.uint64(0xBF58476D1CE4E5B9))
    x ^= x >> np.uint64(31)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(29)
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def load_hourly_trace(path: str) -> np.ndarray:
    """Load an empirical per-hour availability table from a trace file:
    ``.npy``/``.npz`` (first array) or a text/CSV table of numbers.  Rows
    are hours; an optional second axis is the timezone/device bucket."""
    p = str(path)
    if p.endswith(".npy"):
        return np.load(p)
    if p.endswith(".npz"):
        with np.load(p) as z:
            return z[z.files[0]]
    return np.loadtxt(p, delimiter="," if p.endswith(".csv") else None)


def hourly_availability(table, *, hour_unit: float = 1.0,
                        ) -> Callable[[np.ndarray, float], np.ndarray]:
    """An ``available_fn(ids, t)`` from an empirical per-hour table (e.g.
    device-usage fractions measured from a real fleet).

    ``table`` is ``(H,)`` or ``(H, B)`` — a str/PathLike loads through
    ``load_hourly_trace``.  Hour ``floor(t / hour_unit) % H`` indexes the
    first axis (the table wraps, i.e. it is one diurnal/weekly cycle):

    * ``(H, B)`` boolean/0-1 masks: client ``id`` belongs to timezone
      bucket ``id % B`` and is available iff ``table[hour, id % B]``;
    * ``(H,)`` fractions in [0, 1]: each client resolves the fraction with
      its own deterministic per-(id, hour) uniform, so an 0.3 hour keeps
      ~30% of the fleet online — the *same* 30% every time that hour is
      asked about.
    """
    if isinstance(table, (str, os.PathLike)):
        table = load_hourly_trace(table)
    table = np.asarray(table)
    if table.ndim not in (1, 2) or table.shape[0] < 1:
        raise ValueError(
            f"hourly table must be (H,) or (H, B) with H >= 1, "
            f"got shape {table.shape}")
    if hour_unit <= 0:
        raise ValueError(f"hour_unit must be > 0, got {hour_unit}")
    if table.ndim == 1 and (table.min() < 0 or table.max() > 1):
        raise ValueError(
            "fractional (H,) availability values must lie in [0, 1], "
            f"got range [{table.min()}, {table.max()}]")
    hours = table.shape[0]

    def available_fn(ids: np.ndarray, t: float) -> np.ndarray:
        ids = np.asarray(ids)
        hour = int(np.floor(float(t) / hour_unit)) % hours
        if table.ndim == 2:
            return np.asarray(table[hour, ids % table.shape[1]], bool)
        return _mix_u01(ids, hour) < float(table[hour])

    return available_fn


class AvailabilitySampler:
    """Cohorts restricted to an availability trace.

    ``available_fn(ids, t) -> bool mask`` answers which of the candidate ids
    are online at time ``t`` (the round index in the sync runtime, the
    simulated clock in the async one) — e.g. diurnal cycles as a function of
    ``client_id % timezone_buckets``.  Candidates are streamed uniformly and
    filtered; a trace too sparse to fill the cohort raises instead of
    spinning.  ``from_hourly`` builds the mask from an empirical per-hour
    availability array (trace-file-driven device-usage data) instead of a
    synthetic callable.
    """

    def __init__(self, available_fn: Callable[[np.ndarray, float], np.ndarray],
                 max_rounds: int = _MAX_REJECT_ROUNDS):
        self.available_fn = available_fn
        self.max_rounds = int(max_rounds)

    @classmethod
    def from_hourly(cls, table, *, hour_unit: float = 1.0,
                    max_rounds: int = _MAX_REJECT_ROUNDS
                    ) -> "AvailabilitySampler":
        """Sampler over an empirical per-hour availability table (array,
        or a trace file path — see ``hourly_availability``)."""
        return cls(hourly_availability(table, hour_unit=hour_unit),
                   max_rounds=max_rounds)

    def sample(self, rng: np.random.Generator, size: int, k: int, *,
               t: float = 0) -> np.ndarray:
        if k > size:
            raise ValueError(f"cohort {k} exceeds population {size}")
        chosen: list = []
        seen: set = set()
        for _ in range(self.max_rounds):
            cand = _distinct_uniform(rng, size, min(size - len(seen), 2 * k),
                                     exclude=seen)
            seen.update(int(c) for c in cand)
            mask = np.asarray(self.available_fn(cand, t), bool)
            chosen.extend(int(c) for c in cand[mask])
            if len(chosen) >= k:
                return np.asarray(chosen[:k], np.int64)
            if len(seen) >= size:
                break
        raise RuntimeError(
            f"availability trace too sparse at t={t}: found {len(chosen)} "
            f"available clients of the {k} needed (population {size})")


# config-string-constructible samplers; weighted/availability need callables,
# so they are only reachable by passing a ClientPopulation object explicitly
SAMPLERS = {"uniform": UniformSampler}


class ClientPopulation:
    """An abstract client-id space ``[0, size)`` with streaming cohorts."""

    def __init__(self, size: int, *, seed: int = 0,
                 sampler: Optional[object] = None):
        if size < 1:
            raise ValueError(f"population size must be >= 1, got {size}")
        self.size = int(size)
        self.seed = int(seed)
        self.sampler = sampler if sampler is not None else UniformSampler()

    # ------------------------------------------------------------ cohorts

    def sample_cohort(self, round_index: int, cohort_size: int) -> np.ndarray:
        """One round's cohort: distinct global ids, seeded per (seed, round).

        Reproducible in isolation — no generator is threaded between rounds,
        so round r's cohort is the same whether rounds 0..r-1 ran or not.
        """
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, _COHORT_TAG,
                                    int(round_index))))
        ids = np.asarray(self.sampler.sample(rng, self.size,
                                             int(cohort_size),
                                             t=int(round_index)), np.int64)
        self._check_ids(ids, cohort_size)
        return ids

    def sample_dispatch(self, rng: np.random.Generator, exclude=frozenset(),
                        t: float = 0) -> int:
        """One client for an async dispatch slot, skipping in-flight ids."""
        for _ in range(_MAX_REJECT_ROUNDS * 16):
            ids = self.sampler.sample(rng, self.size, 1, t=t)
            if int(ids[0]) not in exclude:
                return int(ids[0])
        raise RuntimeError(
            f"could not draw an idle client: {len(exclude)} of {self.size} "
            "ids are in flight and the sampler keeps returning them")

    def _check_ids(self, ids: np.ndarray, k: int) -> None:
        if len(ids) != k or len(np.unique(ids)) != k:
            raise ValueError(
                f"sampler returned {len(ids)} ids "
                f"({len(np.unique(ids))} distinct) for cohort size {k}")
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise ValueError(
                f"sampler returned ids outside [0, {self.size}): "
                f"[{ids.min()}, {ids.max()}]")

    # --------------------------------------------------- per-client streams

    def _check_id(self, client_id: int) -> int:
        cid = int(client_id)
        if not 0 <= cid < self.size:
            raise ValueError(
                f"client id {cid} outside id space [0, {self.size})")
        return cid

    def client_rng(self, client_id: int, salt: int = 0) -> np.random.Generator:
        """A numpy generator owned by ``client_id`` alone (host-side draws:
        batch sampling, latency realizations).  ``salt`` separates uses
        within one client — the round index (sync) or the client's dispatch
        count (async)."""
        return np.random.default_rng(
            np.random.SeedSequence((self.seed, _CLIENT_TAG,
                                    self._check_id(client_id), int(salt))))

    def client_key(self, client_id: int, salt: int = 0) -> int:
        """The client's device-side seed (Sophia's Hutchinson probes): one
        integer from ``SeedSequence((seed, tag, client_id, salt))``, in
        place of the reference's ``fold_in`` key, whose bits a
        ``torch.Generator`` cannot reproduce.  Like ``client_rng`` it
        depends on neither the population size nor the cohort."""
        state = np.random.SeedSequence(
            (self.seed, _KEY_TAG, self._check_id(client_id),
             int(salt))).generate_state(1, np.uint64)[0]
        return int(state & np.uint64(2 ** 63 - 1))

    def cohort_keys(self, cohort, salt: int = 0) -> np.ndarray:
        """(S,) int64 per-client seeds for a whole cohort."""
        return np.asarray([self.client_key(int(c), salt)
                           for c in np.asarray(cohort).ravel()], np.int64)

    def __repr__(self):
        return (f"ClientPopulation(size={self.size}, seed={self.seed}, "
                f"sampler={type(self.sampler).__name__})")


def make_population(fed) -> ClientPopulation:
    """Build the population a config describes (``population_size``,
    ``cohort_sampler``, ``seed``).  Richer samplers (weighted, availability
    traces) carry callables a config string cannot, so they are passed as
    ready ``ClientPopulation`` objects instead."""
    if getattr(fed, "population_size", None) is None:
        raise ValueError("make_population needs a config with "
                         "population_size set")
    name = getattr(fed, "cohort_sampler", "uniform")
    if name not in SAMPLERS:
        raise ValueError(
            f"unknown cohort_sampler {name!r} (config strings support "
            f"{sorted(SAMPLERS)}; pass a ClientPopulation for weighted/"
            "availability sampling)")
    return ClientPopulation(fed.population_size, seed=fed.seed,
                            sampler=SAMPLERS[name]())


def resolve_population(fed, population=None) -> Optional[ClientPopulation]:
    """Both runtimes' population plumbing: None unless the config activates
    population mode; an explicitly-passed ``ClientPopulation`` (the only way
    to carry weighted/availability samplers) must agree with the config's
    sizing knobs."""
    if population is None:
        if not getattr(fed, "population_active", False):
            return None
        return make_population(fed)
    if not getattr(fed, "population_active", False):
        raise ValueError(
            "a ClientPopulation was passed but population_size is not set — "
            "population mode needs the FedConfig knobs (population_size, "
            "cohort_size) for validation and sizing")
    if population.size != fed.population_size:
        raise ValueError(
            f"population.size {population.size} != fed.population_size "
            f"{fed.population_size}")
    return population
