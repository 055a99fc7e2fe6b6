"""``AsyncFederatedExperiment`` — the buffered-asynchronous execution model
for every stateless-client ``AlgorithmSpec`` (counterpart of
``repro/fed/async_runtime/experiment.py``).

Interchangeable with the synchronous ``FederatedExperiment`` through
``fed.base.FedExperiment``: one ``run_round()`` is one buffer flush (one
server version).  A client trains at dispatch under the then-current
server snapshot (params, Theta^v, g_G^v) and its wire messages are
delivered by the simulated-time scheduler after its sampled latency,
possibly several versions later; the flush then decays each arrival's
delta and Theta by w(s_i) (buffer.py).

A dispatch runs the sync runtime's stacked local update with one client
(S=1: batches ``(1, K, ...)``), so every grouped kernel launch of a local
step covers that client's leaves, and the flush joins the buffered
one-client messages along the client axis (``concat_clients``).  The
draws follow the reference: the scheduler is seeded with ``fed.seed``;
batches and the per-dispatch integer come from
``np.random.default_rng(fed.seed + 1)``, the client's K batches first.
That integer seeds Sophia's Hutchinson probes (``probe_fn(seed, k)``, if
set, replaces them, as ``build_round_fn``'s does).  Error-feedback
residuals are stacked ``(N, ...)`` on the device; a dispatch gathers its
client's row and writes the refreshed row back in place.

Algorithms with per-client persistent state (``spec.client_state``,
SCAFFOLD) are rejected: buffered execution has no lock-step state
exchange.

Population mode (``fed.population_size`` set, or a ``population=``): the
scheduler draws stable global ids from the abstract id space; a
dispatch's batches come from the client's own generator and its probe
seed from ``ClientPopulation.client_key``, both salted with the client's
dispatch count; the error-feedback residuals live in the budgeted sparse
store (``fed.population``), addressed by slot, and the in-flight pool
sizes from ``cohort_size`` (or ``AsyncConfig.concurrency``).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import init_server
from repro_torch.core.algorithms import (
    AlgorithmSpec, EF_STATE, make_local_update, make_wire_client_step,
    resolve, zero_theta,
)
from repro_torch.core.client import LocalRunConfig
from repro_torch.core.engine import (
    BETA_MAX_AUTO, advance_server, make_cohort_executor, make_controller,
)
from repro_torch.core.transport import concat_clients
from repro_torch.fed.async_runtime.buffer import (
    AsyncConfig, make_async_aggregate_fn,
)
from repro_torch.fed.async_runtime.scheduler import SimScheduler
from repro_torch.fed.async_runtime.staleness import make_staleness_weight
from repro_torch.fed.base import FedExperiment
from repro_torch.fed.population import (
    make_client_store, resolve_population, stage_client_population_batches,
)
from repro_torch.fed.rounds import FedConfig, resolve_lr
from repro_torch.fed.staging import stage_client_batches
from repro_torch.obs.telemetry import telemetry_dict
from repro_torch.utils.hw import resolve_device, synchronize
from repro_torch.utils.tree import tree_map


class AsyncFederatedExperiment(FedExperiment):
    """Buffered-asynchronous federated runtime (FedBuff execution model)."""

    def __init__(self, fed: FedConfig, params, loss_fn: Callable,
                 client_batch_fn: Callable, eval_fn: Optional[Callable] = None,
                 opt_kwargs: Optional[dict] = None,
                 async_cfg: Optional[AsyncConfig] = None,
                 spec: Optional[AlgorithmSpec] = None,
                 population: Optional[object] = None):
        super().__init__(fed)
        self.population = resolve_population(fed, population)
        self.device = resolve_device(fed.device)
        self.acfg = async_cfg or AsyncConfig()
        self.loss_fn = loss_fn
        self.client_batch_fn = client_batch_fn
        self.eval_fn = eval_fn
        self.probe_fn = None
        params = tree_map(lambda p: p.to(self.device), params)

        self._bind_spec(spec if spec is not None else fed.algorithm,
                        params, opt_kwargs)

        beta = self.spec.resolve_beta(fed.beta)
        ctrl = make_controller(beta, correct=self.spec.correct,
                               beta_max=BETA_MAX_AUTO, device=self.device)
        self._weight_fn = make_staleness_weight(
            self.acfg.staleness_mode, self.acfg.staleness_alpha,
            self.acfg.hinge_threshold)
        self.server = init_server(params, geom=ctrl)
        if self.population is not None:
            # participation fractions don't scale to 10^6-id spaces: the
            # in-flight pool sizes from cohort_size (or the explicit knob)
            concurrency = self.acfg.concurrency
            if concurrency is None:
                concurrency = max(self.acfg.buffer_size, fed.cohort_size)
            concurrency = max(1, min(concurrency, self.population.size))
            if self.acfg.buffer_size > concurrency:
                raise ValueError(
                    f"buffer_size={self.acfg.buffer_size} exceeds the "
                    f"population-mode concurrency {concurrency} — raise "
                    "AsyncConfig.concurrency or cohort_size")
        else:
            concurrency = self.acfg.resolve_concurrency(fed.n_clients,
                                                        fed.participation)
        self.scheduler = SimScheduler(self.acfg.latency, fed.n_clients,
                                      concurrency, seed=fed.seed,
                                      population=self.population)
        # batches and seeds draw from a separate stream so the simulated
        # event order is invariant to how many batch samples a client
        # consumes
        self.rng = np.random.default_rng(fed.seed + 1)
        self.total_dropped = 0
        self.total_discarded = 0
        # flushes evaluate; the traffic runtime turns this off when its
        # anytime eval samples a simulated-time grid of its own
        self._flush_eval = True

    # ------------------------------------------------------------ algorithm

    def _bind_spec(self, spec, params, opt_kwargs: Optional[dict]) -> None:
        """Resolve ``spec`` and build what derives from it: the optimizer,
        lr, transport, the one-client wire step, the flush and the EF
        residuals.  Called at construction, and again by the traffic
        runtime's hot-swap (``fed.traffic.hotswap.apply_swap``)."""
        fed = self.fed
        self.spec = resolve(spec)
        if self.spec.client_state is not None:
            raise ValueError(
                f"algorithm {self.spec.name!r} declares lock-step per-client "
                "persistent state, which buffered-asynchronous execution "
                "cannot exchange — use the synchronous runtime")
        self.opt = self.spec.make_optimizer(**(opt_kwargs or {}))
        self.align = self.spec.align
        self.lr = resolve_lr(fed, self.spec)
        run = LocalRunConfig(lr=self.lr, local_steps=fed.local_steps,
                             hessian_freq=fed.hessian_freq, align=self.align)
        # the client encodes its uploads at dispatch: the buffer holds
        # wire messages, and the flush reduces them without decoding
        self.transport = fed.make_transport(self.spec)
        self._ef = self.transport.feedback_active
        self._client_step = make_wire_client_step(
            self.spec, make_local_update(self.spec, self.loss_fn, self.opt,
                                         run),
            self.transport, EF_STATE if self._ef else None, fused=True,
            cohort_exec=make_cohort_executor(fed.executor_config()))
        self._wire_cell = {}
        self._flush_fn = make_async_aggregate_fn(
            lr=self.lr, local_steps=fed.local_steps, server_lr=fed.server_lr,
            align=self.align, mixing=self.spec.mixing,
            transport=self.transport, wire_cell=self._wire_cell,
            telemetry=True)
        # EF residuals: stacked (N, ...) on the legacy path; in population
        # mode a budgeted sparse store whose rows a dispatch addresses by
        # slot (cold rows spill through the checkpoint store)
        self._ef_store = self._ef_state = None
        if self._ef and self.population is not None:
            self._ef_store = make_client_store(
                EF_STATE, params, fed.population_size,
                budget=fed.resolve_state_budget(), spill_dir=fed.spill_dir)
        elif self._ef:
            self._ef_state = EF_STATE.init(params, fed.n_clients)
        self._theta0 = zero_theta(self.opt, params) if self.align else None

    # ------------------------------------------------------------ clients

    def _client_payload(self, cid: int):
        """Train client ``cid`` on the current server snapshot (dispatch).

        The payload holds wire messages — the delta (error-compensated for
        a lossy codec) and, for aligned algorithms, Theta — each stacked
        with a client axis of 1, and the client's mean local loss."""
        t = self.tracer
        pop = self.population
        with t.span("staging", client_id=cid, sim_time=self.scheduler.now):
            if pop is not None:
                salt = self.scheduler.dispatch_salt(cid)
                batches = stage_client_population_batches(
                    self.client_batch_fn, pop, cid, self.fed.local_steps,
                    self.device, salt=salt)
                seed = pop.cohort_keys([cid], salt=salt)   # its own seed
            else:
                batches = stage_client_batches(
                    self.client_batch_fn, cid, self.fed.local_steps,
                    self.rng, self.device)
                seed = int(self.rng.integers(0, 2**31))
        theta = self.server.theta if self.server.theta is not None \
            else self._theta0
        slot = (int(self._ef_store.acquire([cid])[0])
                if self._ef_store is not None else cid)
        ids = torch.tensor([slot], dtype=torch.long, device=self.device)
        probes = (None if self.probe_fn is None
                  else functools.partial(self.probe_fn, seed))
        with t.span("local_update", client_id=cid,
                    sim_time=self.scheduler.now):
            dmsg, tmsg, new_residual, loss = self._client_step(
                self.server.params, theta, self.server.g_global,
                self.server.geom.beta, self._residuals(), ids, batches,
                seed=seed, probe_fn=probes)
            if t.enabled:
                synchronize(self.device)
        if self._ef:
            # the client's row, written in place (no copy of the stacked
            # residuals a dispatch)
            EF_STATE.server_update(self._residuals(), ids, new_residual,
                                   None)
        return {"delta": dmsg, "theta": tmsg, "loss": loss}

    def _residuals(self):
        """The stacked EF residuals (the store's slots in population
        mode), or None without feedback."""
        return (self._ef_store.state if self._ef_store is not None
                else self._ef_state)

    # ------------------------------------------------------------ loop

    def run_round(self):
        """Collect ``buffer_size`` usable client reports, then flush."""
        acf, sched, t = self.acfg, self.scheduler, self.tracer
        version = self.server.round
        sched.fill(version, self._client_payload)
        buffered, stale, weights = [], [], []
        dropped = discarded = 0
        events_budget = 100 * acf.buffer_size + 100
        while len(buffered) < acf.buffer_size:
            events_budget -= 1
            if events_budget <= 0:
                raise RuntimeError(
                    "buffer starved: dropout/max_staleness reject every "
                    "arrival — loosen AsyncConfig")
            ev = sched.next_completion()
            # replacement trains from the *current* server state
            sched.fill(version, self._client_payload)
            if ev.dropped:
                dropped += 1
                t.client_dropped(ev.client_id, reason="dropout",
                                 version=ev.version, sim_time=ev.time)
                continue
            s = version - ev.version
            if acf.max_staleness is not None and s > acf.max_staleness:
                discarded += 1
                t.client_dropped(ev.client_id, reason="max_staleness",
                                 version=ev.version, sim_time=ev.time)
                self._discard_restore(ev)
                continue
            buffered.append(ev)
            stale.append(s)
            weights.append(self._weight_fn(s))

        return self._flush_buffer(buffered, stale, weights,
                                  dropped=dropped, discarded=discarded)

    def _discard_restore(self, ev) -> None:
        """An arrival whose work will never reach the server: add its
        decoded delta back into the client's EF residual row, so the
        compression error is delayed, never lost.  No-op without
        feedback."""
        if not self._ef:
            return
        # re-acquire in population mode: the row may have been evicted
        # (and spilled) while this result was in flight
        slot = (int(self._ef_store.acquire([ev.client_id])[0])
                if self._ef_store is not None else ev.client_id)
        decoded = self.transport.delta.decode(ev.payload["delta"])
        tree_map(lambda row, d: row[slot].add_(d[0].to(row.dtype)),
                 self._residuals(), decoded)

    def _flush_buffer(self, buffered, stale, weights, *,
                      dropped: int = 0, discarded: int = 0) -> dict:
        """Aggregate a full buffer into one server version: the flush,
        ``advance_server``, and the round record (history + trace)."""
        sched, t = self.scheduler, self.tracer
        rnum = self.server.round + 1   # the round this flush produces

        with t.span("flush", round=rnum, sim_time=sched.now):
            deltas = concat_clients([ev.payload["delta"] for ev in buffered])
            thetas = concat_clients([ev.payload["theta"] for ev in buffered])
            w = torch.tensor(weights, dtype=torch.float32,
                             device=self.device)
            theta_ref = self.server.theta if self.server.theta is not None \
                else self._theta0
            p, th, g, ctrl, metrics = self._flush_fn(
                self.server.params, theta_ref, self.server.g_global,
                self.server.geom, deltas, thetas, w,
                torch.tensor(stale, dtype=torch.int32, device=self.device))
            if t.enabled:
                synchronize(self.device)
        self.server = advance_server(self.server, p, th if self.align else
                                     None, g, geom=ctrl, aligned=self.align)

        self.total_dropped += dropped
        self.total_discarded += discarded
        tele = metrics.pop("telemetry", None)
        self.last_telemetry = tele
        rec = {k: float(v) for k, v in metrics.items()}
        if "total" in self._wire_cell:
            # exact host ints: upload_bytes is the per-client figure, the
            # untruncated total and the buffer size ride along
            total = int(self._wire_cell["total"])
            cohort = int(self._wire_cell["cohort"])
            rec["upload_bytes"] = float(total // cohort)
            rec["upload_total_bytes"] = float(total)
            rec["cohort_size"] = float(cohort)
        rec.update({
            "loss": float(np.mean([float(ev.payload["loss"])
                                   for ev in buffered])),
            "staleness": float(np.mean(stale)),
            "max_staleness": float(np.max(stale)),
            "sim_time": float(sched.now),
            "dropped": float(dropped),
            "discarded": float(discarded),
        })
        rec["round"] = self.server.round
        if self._ef_store is not None:
            rec.update(state_resident=self._ef_store.resident,
                       state_peak=self._ef_store.peak_resident,
                       state_spills=self._ef_store.spills,
                       state_restores=self._ef_store.restores)
        if self.eval_fn is not None and self._flush_eval:
            with t.span("eval", round=rnum, sim_time=sched.now):
                rec.update({k: float(v) for k, v in
                            self.eval_fn(self.server.params).items()})
        if t.enabled:
            t.round_event(rec["round"], rec, sim_time=float(sched.now),
                          telemetry=telemetry_dict(tele) if tele is not None
                          else None)
        self.history.append(rec)
        return rec

    # ------------------------------------------------------------ accounting

    def comm_bytes_per_round(self) -> int:
        return self.transport.round_bytes(
            self.server.params,
            self.server.theta if self.spec.align else None)
