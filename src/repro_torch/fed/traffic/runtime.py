"""``TrafficExperiment`` — trace-driven continuous-traffic execution
(counterpart of ``repro/fed/traffic/runtime.py``).

Where the round-shaped async runtime asks "collect ``buffer_size`` reports,
flush, repeat N times", this runtime replays an open-ended **arrival
trace**: clients arrive at simulated times drawn from an
:class:`~repro_torch.fed.traffic.traces.ArrivalProcess`, train under the
server snapshot current at their arrival, and report back after their
sampled latency.  The stream runs under *budgets* — simulated seconds
and/or wall-clock seconds — instead of a round count, and progress is
measured by **anytime eval**: the server model evaluated on a fixed
simulated-time grid, independent of when flushes happen
(``eval_history``).

One event loop merges the simulated-time streams, tie-broken by the
reference's fixed priority so the order is deterministic per seed:

  completion < arrival < churn < anytime-eval < flush-tick < algo-swap

* **completion** — the scheduler heap pops a client report; it joins the
  aggregation buffer (or is dropped/discarded/voided, each a traced
  event).  Under the ``"count"`` buffer policy a full buffer flushes
  immediately (FedBuff); under ``"interval"`` the buffer waits for the
  periodic flush tick.
* **arrival** — one client is admitted into the bounded in-flight pool;
  if the pool is full the arrival queues (``backlog``) and admits at the
  next free slot.  A *saturating* trace (``ConstantRate(rate=inf)``)
  refills the pool the instant a slot frees, in the event order of the
  round-shaped runtime: a zero-churn saturating trace with the ``"count"``
  policy reproduces the round-shaped async run metric for metric.
* **churn** — ids join/leave the population (:class:`Membership`);
  departures evict persistent client state and void in-flight work.
* **swap** — the live algorithm is hot-swapped mid-stream
  (``fed.traffic.hotswap``) with warm-started geometry.

The event stream — arrival times, dispatched ids, churn, flush versions —
is the reference's bit for bit: every draw is numpy, from the same
generators in the same order.  A dispatch trains through the async
runtime's one-client step, so its kernel launches are the async path's.

Mid-stream checkpointing (``save_checkpoint``/``load_checkpoint``) writes
the server through ``checkpoint.store`` (tracer identity included) and the
scalar stream state (clocks, every rng, membership, control-event
timeline) as ``traffic.json``, both in the reference's format, and the
payload-carrying events (in-flight heap + aggregation buffer wire
messages) as a pickle of host numpy arrays, restored onto the run's
device.  That pickle holds the port's own message classes, so a
mid-stream traffic checkpoint restores within one package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.store import (
    latest_step, load_meta, load_pytree, load_server_state, save_pytree,
    save_server_state,
)
from repro_torch.fed.async_runtime.experiment import AsyncFederatedExperiment
from repro_torch.fed.async_runtime.scheduler import Completion
from repro_torch.fed.population.state import ClientStateStore
from repro_torch.fed.traffic.traces import (
    ArrivalProcess, ChurnConfig, ConstantRate, Membership, TRACES,
    make_trace,
)
from repro_torch.obs.trace import Tracer
from repro_torch.utils.tree import tree_map

_INF = float("inf")

# deterministic tie-break when several streams land on one simulated instant
_PRIO = {"completion": 0, "arrival": 1, "churn": 2, "eval": 3,
         "flush": 4, "swap": 5}

BUFFER_POLICIES = ("count", "interval")


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Continuous-traffic knobs (composes with ``FedConfig``/``AsyncConfig``).

    trace           arrival process: a catalog name (``TRACES``) or a
                    ready-made ``ArrivalProcess`` instance
    trace_kwargs    kwargs for the named trace (rate, base, period, ...)
    churn           ``ChurnConfig`` for join/leave dynamics (None: static)
    buffer_policy   "count" — flush when ``AsyncConfig.buffer_size`` reports
                    are buffered (FedBuff); "interval" — flush every
                    ``flush_interval`` simulated seconds, whatever arrived
    flush_interval  period of the "interval" policy (simulated seconds)
    eval_every      anytime-eval period in simulated seconds (None: eval
                    only at flushes, the round-shaped behavior)
    sim_budget      default simulated-seconds budget for ``run_stream``
    wall_budget     default wall-clock-seconds budget for ``run_stream``
    swap_to         algorithm name to hot-swap to mid-stream (optional)
    swap_at         simulated time of the swap (required with swap_to)
    seed            trace/churn stream seed (None: derives from fed.seed)
    """
    trace: Union[str, ArrivalProcess] = "constant"
    trace_kwargs: Optional[dict] = None
    churn: Optional[ChurnConfig] = None
    buffer_policy: str = "count"
    flush_interval: Optional[float] = None
    eval_every: Optional[float] = None
    sim_budget: Optional[float] = None
    wall_budget: Optional[float] = None
    swap_to: Optional[str] = None
    swap_at: Optional[float] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.trace, str) and self.trace not in TRACES:
            raise ValueError(
                f"unknown trace {self.trace!r} (want one of {TRACES} "
                "or an ArrivalProcess instance)")
        if self.buffer_policy not in BUFFER_POLICIES:
            raise ValueError(
                f"unknown buffer_policy {self.buffer_policy!r} "
                f"(want one of {BUFFER_POLICIES})")
        if self.buffer_policy == "interval" and \
                not (self.flush_interval and self.flush_interval > 0):
            raise ValueError(
                "buffer_policy='interval' needs flush_interval > 0")
        if self.eval_every is not None and self.eval_every <= 0:
            raise ValueError(f"eval_every must be > 0, got {self.eval_every}")
        if (self.swap_to is None) != (self.swap_at is None):
            raise ValueError("swap_to and swap_at come together")


@dataclasses.dataclass(frozen=True)
class _HostArray:
    """A payload tensor in a checkpoint: its bits in a numpy array (raw
    bits for bf16, which numpy has no type for) and its dtype."""
    bits: np.ndarray
    dtype: torch.dtype


def _map_tensors(fn, x):
    """``fn`` over every tensor of a payload: dicts, lists, tuples and the
    transport's message dataclasses (``WireMsg``/``LeafMsg``)."""
    if isinstance(x, (torch.Tensor, _HostArray)):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_tensors(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_tensors(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _map_tensors(fn, getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def _to_host(t: torch.Tensor) -> _HostArray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _HostArray(t.view(torch.int16).numpy().copy(), t.dtype)
    return _HostArray(t.numpy().copy(), t.dtype)


def _from_host(device):
    def load(h: _HostArray) -> torch.Tensor:
        t = torch.from_numpy(h.bits)
        if h.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(device)
    return load


class TrafficExperiment(AsyncFederatedExperiment):
    """Open-ended event-stream runtime over the buffered-async engine."""

    def __init__(self, fed, params, loss_fn, client_batch_fn, eval_fn=None,
                 opt_kwargs=None, async_cfg=None, spec=None, population=None,
                 traffic: Optional[TrafficConfig] = None):
        super().__init__(fed, params, loss_fn, client_batch_fn, eval_fn,
                         opt_kwargs, async_cfg, spec, population)
        self.tcfg = traffic if traffic is not None else TrafficConfig()
        tcfg = self.tcfg
        self._opt_kwargs = opt_kwargs
        seed = tcfg.seed if tcfg.seed is not None else fed.seed + 2

        if isinstance(tcfg.trace, ArrivalProcess):
            self.trace = tcfg.trace
        else:
            self.trace = make_trace(tcfg.trace, seed=seed,
                                    **(tcfg.trace_kwargs or {}))
        self._saturating = isinstance(self.trace, ConstantRate) \
            and self.trace.saturating

        pool = self.population.size if self.population is not None \
            else fed.n_clients
        self.membership: Optional[Membership] = None
        if tcfg.churn is not None and tcfg.churn.active:
            if self._saturating:
                raise ValueError(
                    "churn needs an open-loop arrival trace — a saturating "
                    "(rate=inf) trace is the closed-loop legacy regime")
            self.membership = Membership(
                pool, dataclasses.replace(
                    tcfg.churn, seed=tcfg.churn.seed
                    if tcfg.churn.seed else seed + 1))

        if tcfg.eval_every is not None:
            # anytime eval owns the grid; flushes stop evaluating
            self._flush_eval = False

        # open-ended stream state
        self.sim_now = 0.0
        self.backlog = 0                 # arrivals waiting for a pool slot
        self.flushes = 0
        self.eval_history: list = []
        self._buffered: list = []
        self._stale: list = []
        self._weights: list = []
        self._dropped_acc = 0
        self._discarded_acc = 0
        self._void_reason: dict = {}     # dispatch seq -> drop reason
        self._started = False
        self._next_arrival_t = _INF
        self._next_churn = (_INF, None)
        self._next_eval_t = tcfg.eval_every if tcfg.eval_every else _INF
        self._next_flush_t = tcfg.flush_interval \
            if tcfg.buffer_policy == "interval" else _INF
        self._swap_t = tcfg.swap_at if tcfg.swap_to is not None else _INF

    # ------------------------------------------------------------ stream

    def _ensure_started(self) -> None:
        if self._started:
            return
        self._started = True
        if self._saturating:
            # closed loop: the pool starts full, like round 0 of the
            # round-shaped runtime
            self.scheduler.fill(self.server.round, self._client_payload)
        else:
            self._next_arrival_t = self.trace.next_arrival(self.sim_now)
        if self.membership is not None:
            self._next_churn = self.membership.next_event(self.sim_now)

    def _peek_next(self):
        """``(time, priority, kind)`` of the earliest pending event."""
        self._ensure_started()
        tc = self.scheduler.peek_time()
        cands = [(self._next_arrival_t, _PRIO["arrival"], "arrival"),
                 (self._next_churn[0], _PRIO["churn"], "churn"),
                 (self._next_eval_t, _PRIO["eval"], "eval"),
                 (self._next_flush_t, _PRIO["flush"], "flush"),
                 (self._swap_t, _PRIO["swap"], "swap")]
        if tc is not None:
            cands.append((tc, _PRIO["completion"], "completion"))
        t, prio, kind = min(cands)
        return (None if math.isinf(t) else (t, prio, kind))

    def _dispatch(self, version: int) -> bool:
        """Admit one arrival: membership-aware selection under churn,
        otherwise the scheduler's uniform idle draw.  False when churn
        left no idle active candidate (the arrival stays queued)."""
        sched = self.scheduler
        if self.membership is not None:
            cid = self.membership.sample_dispatch(
                sched.rng, exclude=sched._in_flight)
            if cid is None:
                return False
            sched.dispatch(cid, version, self._client_payload)
        else:
            sched.dispatch_one(version, self._client_payload)
        return True

    def _step(self) -> Optional[dict]:
        """Process exactly one event; returns the flush record if this
        event produced a server update, else None."""
        nxt = self._peek_next()
        if nxt is None:
            raise RuntimeError(
                "traffic stream is drained: no completion, arrival, churn, "
                "eval, flush, or swap event is pending")
        t, _, kind = nxt
        self.sim_now = t
        return getattr(self, f"_on_{kind}")(t)

    def _on_completion(self, t: float) -> Optional[dict]:
        acf, sched, tr = self.acfg, self.scheduler, self.tracer
        version = self.server.round
        ev = sched.next_completion()
        if self._saturating:
            # round-shaped order: the replacement dispatches (at the
            # pre-flush version) before the event is processed
            sched.fill(version, self._client_payload)
        elif self.backlog > 0 and sched.in_flight() < sched.concurrency:
            if self._dispatch(version):
                self.backlog -= 1
        if sched.consume_voided(ev):
            reason = self._void_reason.pop(ev.seq, "client_left")
            self._discarded_acc += 1
            tr.client_dropped(ev.client_id, reason=reason,
                              version=ev.version, sim_time=ev.time)
            # no EF restore: a departed client's residual was evicted, and
            # a swapped-out algorithm's wire format no longer decodes
            return None
        if ev.dropped:
            self._dropped_acc += 1
            tr.client_dropped(ev.client_id, reason="dropout",
                              version=ev.version, sim_time=ev.time)
            return None
        s = version - ev.version
        if acf.max_staleness is not None and s > acf.max_staleness:
            self._discarded_acc += 1
            tr.client_dropped(ev.client_id, reason="max_staleness",
                              version=ev.version, sim_time=ev.time)
            self._discard_restore(ev)
            return None
        self._buffered.append(ev)
        self._stale.append(s)
        self._weights.append(self._weight_fn(s))
        if self.tcfg.buffer_policy == "count" \
                and len(self._buffered) >= acf.buffer_size:
            return self._do_flush()
        return None

    def _on_arrival(self, t: float) -> None:
        self.trace.notify_arrival(t)
        if self.scheduler.in_flight() >= self.scheduler.concurrency \
                or not self._dispatch(self.server.round):
            self.backlog += 1
        self._next_arrival_t = self.trace.next_arrival(t)

    def _on_churn(self, t: float) -> None:
        mem, sched, tr = self.membership, self.scheduler, self.tracer
        kind = self._next_churn[1]
        if kind == "join":
            cid = mem.sample_join()
            if cid is not None:
                tr.client_join(cid, sim_time=t)
                # a join can unblock queued arrivals starved of candidates
                while self.backlog > 0 \
                        and sched.in_flight() < sched.concurrency \
                        and self._dispatch(self.server.round):
                    self.backlog -= 1
        else:
            cid = mem.sample_leave()
            if cid is not None:
                seq = sched.void(cid)
                if seq is not None:
                    self._void_reason[seq] = "client_left"
                tr.client_leave(cid, in_flight=seq is not None, sim_time=t)
                self._evict_state(cid)
        self._next_churn = mem.next_event(t)

    def _evict_state(self, cid: int) -> None:
        """A departure forgets the client's persistent server-side rows.
        The stacked residuals' row is zeroed in place, as a dispatch
        writes it: no payload views it (a dispatch gathers its row by
        index, a copy, and the checkpoint writes host copies)."""
        if self._ef_store is not None:
            self._ef_store.evict_client(cid)
        elif self._ef_state is not None:
            tree_map(lambda a: a[cid].zero_(), self._ef_state)

    def _on_eval(self, t: float) -> None:
        if self.eval_fn is None:
            raise ValueError("eval_every set but the experiment has no "
                             "eval_fn")
        with self.tracer.span("eval", round=self.server.round, sim_time=t):
            metrics = {k: float(v)
                       for k, v in self.eval_fn(self.server.params).items()}
        rec = {"sim_time": float(t), "round": int(self.server.round),
               **metrics}
        self.eval_history.append(rec)
        self.tracer.anytime_eval(metrics, sim_time=t,
                                 round=self.server.round)
        self._next_eval_t += self.tcfg.eval_every

    def _on_flush(self, t: float) -> Optional[dict]:
        self._next_flush_t += self.tcfg.flush_interval
        if not self._buffered:
            return None              # nothing arrived this interval
        return self._do_flush()

    def _on_swap(self, t: float) -> None:
        from repro_torch.fed.traffic.hotswap import apply_swap
        apply_swap(self, self.tcfg.swap_to, opt_kwargs=self._opt_kwargs,
                   sim_time=t)
        self._swap_t = _INF

    def _do_flush(self) -> dict:
        # the server clock is the stream clock (an interval flush fires
        # between completions; its record stamps the tick time)
        self.scheduler.now = max(self.scheduler.now, self.sim_now)
        buffered, stale, weights = \
            self._buffered, self._stale, self._weights
        self._buffered, self._stale, self._weights = [], [], []
        dropped, self._dropped_acc = self._dropped_acc, 0
        discarded, self._discarded_acc = self._discarded_acc, 0
        rec = self._flush_buffer(buffered, stale, weights,
                                 dropped=dropped, discarded=discarded)
        self.flushes += 1
        return rec

    def discard_buffer(self, *, reason: str = "algo_swap") -> int:
        """Drop every buffered report (traced per client); the hot-swap
        uses this so stale-format wire messages never reach the new
        aggregator.  Returns how many were discarded."""
        n = len(self._buffered)
        for ev in self._buffered:
            self._discarded_acc += 1
            self.tracer.client_dropped(ev.client_id, reason=reason,
                                       version=ev.version,
                                       sim_time=self.sim_now)
        self._buffered, self._stale, self._weights = [], [], []
        return n

    # ------------------------------------------------------------ driving

    def run_round(self) -> dict:
        """One server update: process events until a flush happens (the
        ``FedExperiment`` contract — lets round-shaped tooling drive a
        traffic stream unchanged)."""
        while True:
            rec = self._step()
            if rec is not None:
                return rec

    def run_stream(self, sim_budget: Optional[float] = None,
                   wall_budget: Optional[float] = None,
                   max_flushes: Optional[int] = None) -> dict:
        """Replay the trace until a budget trips; returns a summary.

        ``sim_budget`` bounds the *simulated* clock (events past it stay
        pending — a later call resumes them), ``wall_budget`` the host
        wall-clock, ``max_flushes`` the number of server updates.  Budgets
        default to the config's; at least one must be set."""
        tcfg = self.tcfg
        sim_budget = sim_budget if sim_budget is not None else tcfg.sim_budget
        wall_budget = wall_budget if wall_budget is not None \
            else tcfg.wall_budget
        if sim_budget is None and wall_budget is None and max_flushes is None:
            raise ValueError("run_stream needs a sim_budget, wall_budget, "
                             "or max_flushes — open-ended otherwise")
        flushes0 = self.flushes
        t0 = time.perf_counter()
        while True:
            if max_flushes is not None \
                    and self.flushes - flushes0 >= max_flushes:
                break
            if wall_budget is not None \
                    and time.perf_counter() - t0 >= wall_budget:
                break
            nxt = self._peek_next()
            if nxt is None:
                break
            if sim_budget is not None and nxt[0] > sim_budget:
                self.sim_now = float(sim_budget)
                break
            self._step()
        return {
            "flushes": self.flushes - flushes0,
            "sim_time": float(self.sim_now),
            "wall_s": time.perf_counter() - t0,
            "evals": len(self.eval_history),
            "backlog": int(self.backlog),
            "dropped": int(self.total_dropped),
            "discarded": int(self.total_discarded),
            "joins": self.membership.joins if self.membership else 0,
            "leaves": self.membership.leaves if self.membership else 0,
            "active": (self.membership.n_active if self.membership
                       else (self.population.size if self.population
                             is not None else self.fed.n_clients)),
        }

    # ------------------------------------------------------- checkpointing

    def save_checkpoint(self, directory: str, step: Optional[int] = None
                        ) -> str:
        """Mid-stream checkpoint: server (+ tracer identity) through the
        checkpoint store, scalar stream state as JSON, payload-carrying
        events (in-flight heap + aggregation buffer) as a pickle of host
        arrays.  Returns the step directory."""
        if isinstance(self._ef_store, ClientStateStore):
            raise NotImplementedError(
                "mid-stream checkpointing under a budgeted sparse EF store "
                "is not supported — raise the state budget so the store is "
                "dense, or use a feedback-free transport")
        step = self.flushes if step is None else int(step)
        save_server_state(self.server, directory, step,
                          telemetry=self.tracer.state())
        d = os.path.join(directory, f"step_{step:08d}")
        state = {
            "sim_now": float(self.sim_now),
            "backlog": int(self.backlog),
            "flushes": int(self.flushes),
            "started": bool(self._started),
            "scheduler": self.scheduler.state(),
            "trace": self.trace.state(),
            "membership": self.membership.state() if self.membership
            else None,
            "batches_rng": self.rng.bit_generator.state,
            "next_arrival_t": self._next_arrival_t,
            "next_churn": [self._next_churn[0], self._next_churn[1]],
            "next_eval_t": self._next_eval_t,
            "next_flush_t": self._next_flush_t,
            "swap_t": self._swap_t,
            "void_reason": {str(k): v
                            for k, v in self._void_reason.items()},
            "total_dropped": int(self.total_dropped),
            "total_discarded": int(self.total_discarded),
            "dropped_acc": int(self._dropped_acc),
            "discarded_acc": int(self._discarded_acc),
            "stale": [int(s) for s in self._stale],
            "weights": [float(w) for w in self._weights],
            "history": self.history,
            "eval_history": self.eval_history,
        }
        with open(os.path.join(d, "traffic.json"), "w") as f:
            json.dump(state, f)

        def events(evs):
            return [(ev.time, ev.seq, ev.client_id, ev.version, ev.dropped,
                     _map_tensors(_to_host, ev.payload)) for ev in evs]

        with open(os.path.join(d, "traffic_events.pkl"), "wb") as f:
            pickle.dump({"heap": events(self.scheduler._heap),
                         "buffered": events(self._buffered)}, f)
        if self._ef_state is not None:
            save_pytree(self._ef_state, os.path.join(d, "ef_state.npz"))
        return d

    def load_checkpoint(self, directory: str, step: Optional[int] = None
                        ) -> None:
        """Restore a ``save_checkpoint`` into this (identically
        constructed) experiment — fresh process included.  Everything the
        constructor randomized is overwritten from the checkpoint."""
        meta = load_meta(directory, step)
        template = self.server
        if meta.get("has_theta") and template.theta is None \
                and self._theta0 is not None:
            # a freshly built experiment has theta=None until its first
            # flush; template with the zero Theta so the saved one loads
            template = dataclasses.replace(template, theta=self._theta0)
        self.server = load_server_state(template, directory, step)
        self.tracer = Tracer.from_state(meta.get("telemetry"),
                                        sinks=self.tracer.sinks)
        if step is None:
            step = latest_step(directory)
        d = os.path.join(directory, f"step_{step:08d}")
        with open(os.path.join(d, "traffic.json")) as f:
            state = json.load(f)
        self.sim_now = float(state["sim_now"])
        self.backlog = int(state["backlog"])
        self.flushes = int(state["flushes"])
        self._started = bool(state["started"])
        self.scheduler.load_state(state["scheduler"])
        self.trace.load_state(state["trace"])
        if state["membership"] is not None:
            if self.membership is None:
                raise ValueError(
                    "checkpoint has churn membership but this experiment "
                    "was built without a ChurnConfig")
            self.membership.load_state(state["membership"])
        self.rng.bit_generator.state = state["batches_rng"]
        self._next_arrival_t = float(state["next_arrival_t"])
        t, kind = state["next_churn"]
        self._next_churn = (float(t), kind)
        self._next_eval_t = float(state["next_eval_t"])
        self._next_flush_t = float(state["next_flush_t"])
        self._swap_t = float(state["swap_t"])
        self._void_reason = {int(k): v
                             for k, v in state["void_reason"].items()}
        self.total_dropped = int(state["total_dropped"])
        self.total_discarded = int(state["total_discarded"])
        self._dropped_acc = int(state["dropped_acc"])
        self._discarded_acc = int(state["discarded_acc"])
        self._stale = [int(s) for s in state["stale"]]
        self._weights = [float(w) for w in state["weights"]]
        self.history = list(state["history"])
        self.eval_history = list(state["eval_history"])
        with open(os.path.join(d, "traffic_events.pkl"), "rb") as f:
            events = pickle.load(f)
        to_dev = _from_host(self.device)

        def completions(evs):
            return [Completion(t_, seq, cid, ver, drp,
                               _map_tensors(to_dev, payload))
                    for t_, seq, cid, ver, drp, payload in evs]

        self.scheduler.restore_events(completions(events["heap"]))
        self._buffered = completions(events["buffered"])
        ef_path = os.path.join(d, "ef_state.npz")
        if self._ef_state is not None:
            self._ef_state = load_pytree(self._ef_state, ef_path)
        if self.population is not None and self._ef_state is None \
                and self._ef_store is None and os.path.exists(ef_path):
            raise ValueError("checkpoint carries an EF state this "
                             "experiment does not use")
