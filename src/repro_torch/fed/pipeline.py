"""Chunk-streaming pipelined population rounds — counterpart of
``repro/fed/pipeline.py``.

The serial population round stages the whole cohort's batches on the
host, restores every cold state row, then runs the cohort at once.  This
module cuts the cohort into ordered chunks and runs the round as a
software pipeline:

  * a background stager (thread pool) fills chunk i+1's batches into
    double-buffered host buffers (``StagingBuffers``, pinned on a CUDA
    run) while chunk i computes: CUDA launches are asynchronous, so a
    chunk's call returns once its kernels are queued, and nothing on the
    chunk path reads a value back to the host before the flush;
  * batches, restored state rows and slot indices cross to the card from
    pinned memory on a copy stream of the pipeline's own, and the compute
    stream waits on that stream's event, not on the host;
  * the sparse state store prefetches chunk i+1's cold rows on its I/O
    threads and writes evictions behind the round;
  * each chunk's wire uploads fold into running f32 weighted sums
    (``engine.stream_chunk``; the qblock codec adds the carry inside the
    ``dequant_accumulate`` launch) and one ``finish_stream`` applies the
    Alg. 2 tail, so the cohort's wire stack never exists whole.

A single-chunk pipeline (``pipeline_chunk >= cohort_size``) folds with no
carry and ``exact=True``, the serial round's expressions, and is bitwise
equal to it.  Multi-chunk streams are reproducible for a fixed chunk size
and identical across stager worker counts: each client's batches come
from its own generator and land in its own buffer row, and its Hutchinson
probes from its own seed.

Client state: chunks read the round-start state (with their own restored
rows grafted in) and write a round-owned copy, cloned at chunk 1, that
every later chunk updates in place, as JAX's donation reuses buffers; the
store's state becomes that copy at the flush.  Chunks own disjoint slot
sets, so their scatters never collide, and shared globals (SCAFFOLD's
``c_global``) telescope to the cohort total.  The running carry and loss
sum are updated in place from chunk 2 on.  Restored rows need no padding
to a fixed count: PyTorch compiles no program per shape.

The pipeline is a population-mode, sync-runtime feature behind
``FedConfig.pipeline``; algorithms with a mixing hook keep the serial
round (``fed.rounds`` warns and falls back).
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import transport as T
from repro_torch.core.algorithms import (
    make_local_update, make_wire_client_step, round_client_state_spec,
    state_import_many, zero_theta,
)
from repro_torch.core.client import LocalRunConfig
from repro_torch.core.engine import (
    AggregationConfig, BETA_MAX_AUTO, ExecutorConfig, advance_server,
    finish_stream, make_cohort_executor, make_controller, stream_chunk,
    update_controller,
)
from repro_torch.fed.staging import (
    StagingBuffers, _stack_steps, serialized_unless_thread_safe,
)
from repro_torch.utils.tree import tree_leaves, tree_map

_BUF = "pipe"   # StagingBuffers tag; keyed with the parity -> two trees


def _chunk_executor(cfg: ExecutorConfig):
    """The per-chunk executor: the chunk is the memory bound, so the
    chunked backends collapse to one vmap over the chunk."""
    if cfg.backend in ("vmap", "chunked"):
        return make_cohort_executor(ExecutorConfig(backend="vmap"))
    return make_cohort_executor(
        dataclasses.replace(cfg, backend="shard_map"))


def _clone(tree):
    """A copy of a state tree (dicts, sequences, dataclasses, tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _clone(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


class RoundPipeline:
    """Chunk-streaming round runner bound to one ``FederatedExperiment``.

    ``run_round()`` replaces the serial round and returns the same metrics
    plus ``pipeline_bubble`` (the share of the round's wall time the host
    spent blocked on staging and restores, the pipeline's figure of
    merit), ``pipeline_chunks``, ``pipeline_chunk_size``,
    ``pipeline_stage_wait_s`` and ``pipeline_restore_wait_s``.
    """

    def __init__(self, exp):
        fed = exp.fed
        spec = exp.spec
        if not fed.population_active:
            raise ValueError("RoundPipeline requires population mode")
        if spec.mixing is not None:
            raise ValueError(
                f"algorithm {spec.name!r} has a mixing hook (needs the "
                "decoded cohort stack); the chunk-streaming pipeline "
                "cannot serve it — use the serial round")
        self.exp = exp
        self.spec = spec
        self.opt = exp.opt
        self.transport = exp.transport
        self.device = exp.device
        self.cohort_size = fed.cohort_size
        self.chunk = max(1, min(fed.pipeline_chunk, fed.cohort_size))
        self.bounds = tuple(
            (a, min(a + self.chunk, self.cohort_size))
            for a in range(0, self.cohort_size, self.chunk))
        self.exact = len(self.bounds) == 1
        self.workers = fed.pipeline_workers
        self.local_steps = fed.local_steps
        self.n_clients = fed.population_size
        self.encode_theta = spec.align
        self.state_proto = round_client_state_spec(spec, exp.transport)
        self.default_ctrl = make_controller(
            spec.resolve_beta(fed.beta), correct=spec.correct,
            beta_max=BETA_MAX_AUTO, device=self.device)
        run = LocalRunConfig(lr=exp.lr, local_steps=fed.local_steps,
                             hessian_freq=fed.hessian_freq, align=spec.align)
        self.agg_cfg = AggregationConfig(lr=exp.lr,
                                         local_steps=fed.local_steps,
                                         server_lr=fed.server_lr,
                                         align=spec.align)
        self.cohort_step = make_wire_client_step(
            spec, make_local_update(spec, exp.loss_fn, exp.opt, run),
            exp.transport, self.state_proto, fused=True,
            cohort_exec=_chunk_executor(fed.executor_config()))

        self.batch_fn = serialized_unless_thread_safe(exp.client_batch_fn)
        self.stager = ThreadPoolExecutor(max_workers=self.workers,
                                         thread_name_prefix="repro-stager")
        self._cuda = self.device.type == "cuda"
        self.sbufs = StagingBuffers(pin=self._cuda)
        self.copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                            else None)
        if exp.state_store is not None:
            exp.state_store.enable_async_io(workers=2)

    # ------------------------------------------------------------- transfers

    def _to_device(self, tree, pinned: bool = False):
        """Host tensors (or numpy arrays) of ``tree`` on the device.  On
        CUDA: from pinned memory, on the copy stream, the compute stream
        waiting on it."""
        if not self._cuda:
            return tree_map(torch.as_tensor, tree)
        if not pinned:
            tree = tree_map(lambda x: torch.as_tensor(x).pin_memory(), tree)
        with torch.cuda.stream(self.copy_stream):
            out = tree_map(lambda x: x.to(self.device, non_blocking=True),
                           tree)
        return self._handoff(out)

    def _handoff(self, tree):
        """Order the compute stream after the copy stream's work so far,
        and keep ``tree``'s memory (allocated on the copy stream) from
        being reused while the compute stream may read it."""
        compute = torch.cuda.current_stream(self.device)
        compute.wait_stream(self.copy_stream)
        for x in tree_leaves(tree):
            x.record_stream(compute)
        return tree

    # ------------------------------------------------------------- one chunk

    def _chunk(self, params, theta, g_global, beta, read_state, write_state,
               carry, loss_sum, slots, pend, batches, seeds, n):
        """Queue one chunk's local rounds, encode and fold; returns
        (write_state, carry, loss_sum, upload bytes).  Reads nothing back
        from the device."""
        proto = self.state_proto
        if proto is not None:
            if pend is not None:
                # the chunk's restored rows: into the round-start state
                # (rows of slots just assigned, read by this chunk alone)
                # and into the round's write state
                pslots, rows = pend
                read_state = state_import_many(proto, read_state, pslots,
                                               rows)
                if write_state is not None:
                    write_state = state_import_many(proto, write_state,
                                                    pslots, rows)
            if write_state is None:
                write_state = _clone(read_state)     # round-owned
        dmsgs, tmsgs, outs, loss = self.cohort_step(
            params, theta, g_global, beta, read_state, slots, batches,
            seed=seeds)
        up = T.wire_bytes(dmsgs)
        if self.encode_theta:
            up += T.wire_bytes(tmsgs)
        w = torch.ones((n,), dtype=torch.float32, device=self.device)
        carry = stream_chunk(carry, dmsgs, w, self.transport,
                             tmsgs=tmsgs if self.encode_theta else None,
                             thetas=None if self.encode_theta else tmsgs,
                             exact=self.exact)
        # the chunk's mean loss -> the sum of its clients' means (the
        # single chunk keeps the serial round's mean as it is)
        ls = loss if self.exact else loss * n
        loss_sum = ls if loss_sum is None else loss_sum.add_(ls)
        if proto is not None:
            write_state = proto.server_update(write_state, slots, outs,
                                              self.n_clients)
        return write_state, carry, loss_sum, up

    def _finish(self, params, theta, g_global, ctrl, carry, loss_sum):
        p, th, g, metrics, _aux = finish_stream(
            params, theta, g_global, carry, self.cohort_size, self.agg_cfg)
        new_ctrl = update_controller(ctrl, metrics["norm_drift"],
                                     metrics["freshness"])
        loss = loss_sum if self.exact else loss_sum / self.cohort_size
        metrics = dict(metrics, loss=loss, beta=ctrl.beta)
        return p, th, g, new_ctrl, metrics

    # ------------------------------------------------------------- staging

    def _submit_stage(self, cohort, bounds, parity, salt):
        """Fan one chunk's clients out over the stager pool: round-robin
        slices write disjoint buffer rows, so completion order cannot
        change the staged values."""
        a, b = bounds
        ids = [int(c) for c in cohort[a:b]]
        n = b - a
        n_tasks = max(1, min(self.workers, n))
        futs = []
        for w in range(n_tasks):
            offs = list(range(w, n, n_tasks))
            futs.append(self.stager.submit(
                self._stage_slice, [ids[o] for o in offs], offs, parity,
                n, salt))
        return futs

    def _stage_slice(self, ids, offs, parity, n, salt):
        pop = self.exp.population
        for cid, off in zip(ids, offs):
            row = _stack_steps(self.batch_fn, cid, self.local_steps,
                               pop.client_rng(cid, salt))
            buf = self.sbufs.get((_BUF, parity), n, row)
            StagingBuffers.fill_row(buf, off, row)

    def _finish_stage(self, futs, parity, n):
        for f in futs:
            f.result()               # propagate stager exceptions
        out = self.sbufs.to_device((_BUF, parity), n, self.device,
                                   stream=self.copy_stream)
        return self._handoff(out) if self._cuda else out

    # ------------------------------------------------------------ the round

    def run_round(self) -> dict:
        """One pipelined round; advances the experiment's server and state
        and returns the metrics (the serial round's keys plus the
        ``pipeline_*`` fields)."""
        exp = self.exp
        t = exp.tracer
        pop = exp.population
        store = exp.state_store
        rnum = exp.server.round + 1
        ridx = rnum - 1                 # staging salt, as in the serial path
        S = self.cohort_size
        t_round = time.perf_counter()

        with t.span("staging", round=rnum):
            cohort = pop.sample_cohort(ridx, S)
            with t.span("state_acquire", round=rnum):
                slots = (store.acquire(cohort, defer_restore=True)
                         if store is not None else np.asarray(cohort))
            seeds = pop.cohort_keys(cohort, salt=ridx)
            slots_dev = self._to_device(
                torch.from_numpy(np.asarray(slots, np.int64)))

        server = exp.server
        ctrl = server.geom if server.geom is not None else self.default_ctrl
        theta = server.theta
        if self.spec.align and theta is None:
            # round 0: no reference yet -> align to the fresh (zero) state
            theta = zero_theta(self.opt, server.params)
        params, g_global = server.params, server.g_global

        read_state = store.state if store is not None else None
        write_state = carry = loss_sum = None
        stage_wait = restore_wait = 0.0
        total_bytes = 0

        stage_futs = {0: self._submit_stage(cohort, self.bounds[0], 0,
                                            ridx)}
        if store is not None:
            a0, b0 = self.bounds[0]
            store.prefetch(cohort[a0:b0])

        for ci, (a, b) in enumerate(self.bounds):
            if ci + 1 < len(self.bounds):
                # chunk i+1 stages and prefetches while chunk i computes
                stage_futs[ci + 1] = self._submit_stage(
                    cohort, self.bounds[ci + 1], (ci + 1) % 2, ridx)
                if store is not None:
                    na, nb = self.bounds[ci + 1]
                    store.prefetch(cohort[na:nb])
            tw = time.perf_counter()
            with t.span("chunk_stage", round=rnum, chunk=ci):
                batches = self._finish_stage(stage_futs.pop(ci), ci % 2,
                                             b - a)
            stage_wait += time.perf_counter() - tw
            pend = None
            tw = time.perf_counter()
            if store is not None:
                with t.span("chunk_restore", round=rnum, chunk=ci):
                    got = store.collect_pending(cohort[a:b])
                    if got is not None:
                        pslots, rows = got
                        pend = (self._to_device(torch.from_numpy(pslots)),
                                self._to_device(rows, pinned=self._cuda))
            restore_wait += time.perf_counter() - tw
            # asynchronous launches: the span times the queueing; the
            # device work overlaps the next chunk's staging, and the flush
            # span waits for it
            with t.span("chunk_compute", round=rnum, chunk=ci):
                write_state, carry, loss_sum, up = self._chunk(
                    params, theta, g_global, ctrl.beta, read_state,
                    write_state, carry, loss_sum, slots_dev[a:b], pend,
                    batches, seeds[a:b], b - a)
            total_bytes += up

        with t.span("flush", round=rnum):
            p, th, g, new_ctrl, metrics = self._finish(
                params, theta, g_global, ctrl, carry, loss_sum)
            if self._cuda:
                torch.cuda.synchronize(self.device)

        if store is not None:
            store.state = write_state
            store.flush_io()
        exp.client_state = write_state
        exp.server = advance_server(server, p, th, g, geom=new_ctrl,
                                    aligned=self.spec.align)

        wall = time.perf_counter() - t_round
        bubble = (stage_wait + restore_wait) / max(wall, 1e-9)
        return dict(metrics,
                    upload_bytes=total_bytes // S,
                    upload_total_bytes=total_bytes, cohort_size=S,
                    pipeline_chunks=len(self.bounds),
                    pipeline_chunk_size=self.chunk,
                    pipeline_bubble=bubble,
                    pipeline_stage_wait_s=stage_wait,
                    pipeline_restore_wait_s=restore_wait)
