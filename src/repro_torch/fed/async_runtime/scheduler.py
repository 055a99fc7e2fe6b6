"""Event-driven simulated-time scheduler for asynchronous federated rounds
(counterpart of ``repro/fed/async_runtime/scheduler.py``, copied: numpy
only, so the same seed gives the same events bit for bit).

Clients are dispatched into a bounded in-flight pool (``concurrency``); each
dispatch draws a completion time from the ``LatencyModel`` and is pushed onto
a min-heap keyed by (time, seq).  ``next_completion()`` pops the earliest
event and advances the simulated clock.  Because every draw comes from one
seeded ``np.random.Generator`` and ties break on the monotone dispatch
sequence number, the event order is fully deterministic per seed — the
property the runtime tests pin down.

All per-client bookkeeping (persistent speeds, dispatch counts, the
in-flight set) is *sparse* — dicts and sets keyed by global client id, no
``n_clients``-sized arrays — so the id space can grow, shrink, or churn
(clients joining and leaving mid-stream, ``fed.traffic``) without the
scheduler ever enumerating it.  The legacy dense branch
(``population=None``) still draws its persistent speeds in one eager batch
from the shared generator, so its event stream stays byte-identical to the
historical dense-array implementation (golden-tested).

Population mode (a ``fed.population.ClientPopulation`` passed in): client
ids are stable *global* ids drawn from the abstract id space, never a dense
0..N-1 enumeration.  Per-client randomness derives from the id itself —
persistent speed via ``LatencyModel.client_speed(seed, cid)``, per-dispatch
latency/dropout from ``SeedSequence((seed, tag, cid, dispatch_index))`` —
so one client's realizations are invariant to population size, to who else
is in flight, and to event interleaving.  Only the *selection* of which
idle client to dispatch consumes the shared scheduler generator.

The scheduler is payload-agnostic: the experiment attaches whatever the
"client" computed at dispatch time (its trained delta/Theta under the
then-current server state) and reads it back on completion, which is exactly
the semantics of a client downloading version v, training, and reporting
back later.  For churn, an in-flight dispatch can be *voided*
(``void(cid)``): the completion still pops (its simulated time passes) but
``consume_voided`` flags it so the experiment discards the work with a
traced reason instead of aggregating it.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.fed.async_runtime.latency import LatencyModel

# domain-separation tag for per-dispatch latency/dropout streams
_DISPATCH_TAG = 0xD15


@dataclasses.dataclass(order=True)
class Completion:
    """A client report-back event in simulated time."""
    time: float
    seq: int                   # dispatch order; deterministic tie-break
    client_id: int = dataclasses.field(compare=False)
    version: int = dataclasses.field(compare=False)   # server version at dispatch
    dropped: bool = dataclasses.field(compare=False, default=False)
    payload: Any = dataclasses.field(compare=False, default=None)


class SimScheduler:
    """Bounded-concurrency client pool over simulated time."""

    def __init__(self, latency: LatencyModel, n_clients: int,
                 concurrency: int, seed: int = 0, population=None):
        self.population = population
        pool = n_clients if population is None else population.size
        if concurrency > pool:
            raise ValueError(
                f"concurrency {concurrency} exceeds the client pool {pool}")
        self.latency = latency
        self.n_clients = n_clients
        self.concurrency = concurrency
        self.rng = np.random.default_rng(seed)
        self._seed = int(seed)
        # sparse per-client bookkeeping, shared by both modes: speeds,
        # dispatch counts, and in-flight membership keyed by global id
        self._speed_of: dict = {}
        self._dispatch_counts: dict = {}
        if population is None:
            # the dense path's persistent speeds are still one eager batched
            # draw from the shared generator (the historical rng stream the
            # golden trace test pins), dict-ified afterwards
            speeds = latency.client_speeds(n_clients, self.rng)
            self._speed_of = {c: float(speeds[c]) for c in range(n_clients)}
        self.now = 0.0
        self._seq = 0
        self._heap: list[Completion] = []
        self._in_flight: set[int] = set()
        self._live_seq: dict = {}      # cid -> seq of its in-flight dispatch
        self._voided: set[int] = set()  # dispatch seqs cancelled by churn

    # ------------------------------------------------------------ dispatch

    def idle_clients(self) -> np.ndarray:
        if self.population is not None:
            raise RuntimeError(
                "population mode has no dense idle list — idle clients are "
                "rejection-sampled from the id space (fill/sample_dispatch)")
        return np.array([c for c in range(self.n_clients)
                         if c not in self._in_flight])

    def dispatch_salt(self, client_id: int) -> int:
        """The dispatch index of ``client_id``'s in-progress (or most
        recent) dispatch — the salt its payload staging must reuse so a
        client's training stream is tied to (id, dispatch), not to global
        event order."""
        return self._dispatch_counts.get(int(client_id), 1) - 1

    def dispatch(self, client_id: int, version: int,
                 payload_fn: Optional[Callable[[int], Any]] = None):
        """Dispatch one client; its result is due after the sampled latency.

        Dropout is drawn *before* ``payload_fn`` runs so a client fated to
        drop never pays for local training — only its simulated time."""
        cid = int(client_id)
        if cid in self._in_flight:
            raise ValueError(f"client {cid} already in flight")
        salt = self._dispatch_counts.get(cid, 0)
        self._dispatch_counts[cid] = salt + 1
        if self.population is None:
            lat = self.latency.sample_latency(self._speed_of[cid], self.rng)
            dropped = self.latency.sample_dropout(self.rng)
        else:
            speed = self._speed_of.get(cid)
            if speed is None:
                speed = self.latency.client_speed(self._seed, cid)
                self._speed_of[cid] = speed
            rng = np.random.default_rng(np.random.SeedSequence(
                (self._seed, _DISPATCH_TAG, cid, salt)))
            lat = self.latency.sample_latency(speed, rng)
            dropped = self.latency.sample_dropout(rng)
        payload = payload_fn(cid) \
            if (payload_fn is not None and not dropped) else None
        ev = Completion(self.now + lat, self._seq, cid,
                        int(version), dropped, payload)
        self._live_seq[cid] = self._seq
        self._seq += 1
        self._in_flight.add(cid)
        heapq.heappush(self._heap, ev)
        return ev

    def dispatch_one(self, version: int,
                     payload_fn: Optional[Callable[[int], Any]] = None):
        """Dispatch one uniformly-sampled idle client (the selection code
        path ``fill`` loops over) — the open-loop arrival hook: one client
        arrives *now*, whoever it turns out to be."""
        if len(self._in_flight) >= self.concurrency:
            raise RuntimeError(
                f"in-flight pool is full ({self.concurrency}) — an arrival "
                "must wait for a completion before it can dispatch")
        if self.population is None:
            idle = self.idle_clients()
            cid = int(self.rng.choice(idle))
        else:
            cid = self.population.sample_dispatch(
                self.rng, exclude=self._in_flight, t=self.now)
        return self.dispatch(cid, version, payload_fn)

    def fill(self, version: int,
             payload_fn: Optional[Callable[[int], Any]] = None):
        """Dispatch uniformly-sampled idle clients until the pool is full."""
        started = []
        while len(self._in_flight) < self.concurrency:
            started.append(self.dispatch_one(version, payload_fn))
        return started

    # ------------------------------------------------------------ completion

    def in_flight(self) -> int:
        return len(self._in_flight)

    def peek_time(self) -> Optional[float]:
        """Simulated time of the earliest pending completion (None when no
        client is in flight) — how the traffic runtime interleaves
        completions with its own control events."""
        return self._heap[0].time if self._heap else None

    def next_completion(self) -> Completion:
        if not self._heap:
            raise RuntimeError("no clients in flight")
        ev = heapq.heappop(self._heap)
        self.now = ev.time
        self._in_flight.discard(ev.client_id)
        if self._live_seq.get(ev.client_id) == ev.seq:
            del self._live_seq[ev.client_id]
        return ev

    # ------------------------------------------------------------ churn

    def void(self, client_id: int) -> Optional[int]:
        """Cancel ``client_id``'s in-flight dispatch (the client left, or
        the algorithm it trained under was swapped out).  The completion
        event stays in the heap — simulated time still passes — but
        ``consume_voided`` will flag it so the caller discards the payload.
        Returns the voided dispatch seq, or None if nothing was in flight."""
        seq = self._live_seq.get(int(client_id))
        if seq is None:
            return None
        self._voided.add(seq)
        return seq

    def consume_voided(self, ev: Completion) -> bool:
        """True iff ``ev`` was voided after dispatch; consumes the mark."""
        if ev.seq in self._voided:
            self._voided.discard(ev.seq)
            return True
        return False

    # --------------------------------------------------------- checkpointing

    def state(self) -> dict:
        """Scalar scheduler state for mid-stream checkpointing.  The heap's
        payload-carrying events are serialized by the experiment (they hold
        device tensors); everything else — the clock, the shared generator,
        and the sparse per-client dicts — round-trips here.  Persistent
        speeds are *not* saved: the dense batch draw replays identically at
        construction and population speeds re-derive from ids."""
        return {
            "now": float(self.now), "seq": int(self._seq),
            "rng": self.rng.bit_generator.state,
            "dispatch_counts": {str(k): int(v)
                                for k, v in self._dispatch_counts.items()},
            "live_seq": {str(k): int(v)
                         for k, v in self._live_seq.items()},
            "voided": sorted(int(s) for s in self._voided),
        }

    def restore_events(self, events) -> None:
        """Re-seat deserialized in-flight ``Completion`` events (the
        payload-carrying half of a checkpoint, saved by the experiment)
        after ``load_state`` has restored the scalar half."""
        self._heap = list(events)
        heapq.heapify(self._heap)
        self._in_flight = {ev.client_id for ev in self._heap}

    def load_state(self, state: dict) -> None:
        self.now = float(state["now"])
        self._seq = int(state["seq"])
        self.rng.bit_generator.state = state["rng"]
        self._dispatch_counts = {int(k): int(v)
                                 for k, v in state["dispatch_counts"].items()}
        self._live_seq = {int(k): int(v)
                          for k, v in state["live_seq"].items()}
        self._voided = set(int(s) for s in state["voided"])
