"""One run of one cell: set-up, the measured window, the trace's reading,
and the comparison with the plain reference that decides ``correct``.

Set-up (``setup_s``, from the process's start): imports, the kernels from
their build caches, the program's scenario materialized from the seed on
the benchmark's weights, and the first ``CHECK_ROUNDS`` rounds of the
experiment through ``FedExperiment.run_round`` (the first pays the Triton
compiles, SOAP's first refresh and telemetry's Omega draw).  Those rounds
are the ones the reference follows: the batches they were fed are recorded
as the program's data source hands them out, and the program's readings
are taken between them.

The window then runs whole rounds back to back on the same experiment,
starting another only while the elapsed time plus the longest round so far
fits in ``seconds``; it ends with the last round's own host reads.  With
``trace`` the window is preceded, while the process is young, by
``TRACE_ROUNDS`` rounds under ``torch.profiler`` (CUDA activity only) with
the program's spans on and CUDA events around them: the device metrics
are read from that trace only where its busy time is at least
``TRACE_SHARE`` of the events' time (a trace that lost kernels reads
less), and ``round_mfu`` from the untraced window.

After the window the program is freed, and the reference runs the checked
rounds again from the benchmark's weights and the recorded batches.
"""
from __future__ import annotations

import gc
import importlib
import math
import sys
import time

import numpy as np

from fedbench import checks, counts, devtrace, spec
from fedbench.reference.common import Precision, flatten, make_weights
from fedbench.reference.fedround import run_rounds

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECK_ROUNDS = 3        # the rounds of set-up that the reference follows
TRACE_ROUNDS = 1        # the rounds a traced run traces
# the least share of the CUDA events' time around the traced rounds that
# the trace's busy time (the union of its operations) may be: sound traces
# read the round's busy share, 0.83 (ViT-Tiny, whose host-paced gaps grow
# on a slower host) to 0.94 (SmolLM-360M); one that dropped kernels reads
# less
TRACE_SHARE = 0.7


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    mods = sys.modules if modules is None else modules
    return sorted({m for m in mods if m.split(".")[0] in FORBIDDEN})


def seeds_of(seed: int) -> dict:
    """The run's seeds, all below 2**31, from any whole number."""
    words = np.random.SeedSequence(int(seed) % 2**64).generate_state(3)
    return dict(zip(("data", "weights", "fed"),
                    (int(w) & 0x7FFFFFFF for w in words)))


class BatchRecorder:
    """The scenario's batch source, recording each batch it hands out
    (client by client, K each, as the program's staging draws them)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def __call__(self, cid, rng):
        batch = self.inner(cid, rng)
        self.calls.append({k: np.array(v, copy=True) for k, v in
                           batch.items()})
        return batch

    def rounds(self, s: int, k: int):
        """Per round, per client, the K step batches."""
        c = self.calls
        if len(c) % (s * k):
            raise ValueError(f"{len(c)} recorded batches for cohorts of {s} "
                             f"x {k}")
        return [[c[r + i * k:r + (i + 1) * k] for i in range(s)]
                for r in range(0, len(c), s * k)]


class TimedSink:
    """The program's trace events, each with the host time it ended."""

    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append((dict(event), time.perf_counter()))

    def spans(self, t0: float):
        """(phase, start, dur) in seconds from ``t0``."""
        return [(e["phase"], t - e["dur_s"] - t0, e["dur_s"])
                for e, t in self.events if e.get("event") == "span"]


def fed_overrides(traffic, seeds, device) -> dict:
    return dict(
        n_clients=traffic["n_clients"], participation=traffic["participation"],
        local_steps=traffic["local_steps"], lr=traffic["lr"],
        beta=traffic["beta"], server_lr=traffic["server_lr"],
        executor=traffic["executor"], chunk_size=traffic["chunk_size"],
        wire_dtype=traffic["wire_dtype"], rounds=10**6, seed=seeds["fed"],
        device=str(device))


def _norms(tree):
    import torch
    return {k: float(torch.linalg.vector_norm(v)) for k, v in flatten(tree)}


def _theta_norms(theta):
    """Global Theta as the reference keys it: "<param>.L"/".R" (SOAP's
    {"LR": ...}), "<param>.m" (Muon's {"m": ...})."""
    out = {}
    for key, v in _norms(theta).items():
        top, rest = key.split(".", 1)
        out[rest if top == "LR" else f"{rest}.{top}"] = v
    return out


def _micro(rows: int, row_tokens: int, budget: int) -> int:
    """Rows a client in each of the reference's blocks: the most that
    divide the batch with the whole cohort's block within ``budget``
    tokens."""
    want = max(1, budget // row_tokens)
    return max(d for d in range(1, rows + 1) if rows % d == 0 and d <= want)


class Run:
    """A cell's run.  ``device`` "cuda" on the chip; the CPU tests drive
    the same run on "cpu" at tiny sizes.  ``plant`` (tests and
    calibration) may break the program underneath: ``plant.scenario(scn)``
    before the experiment is built, ``plant.experiment(exp)`` after."""

    def __init__(self, wl, cfg, traffic, cell, *, seed, seconds, trace,
                 device="cuda", plant=None, t_start=None, guard=True):
        self.wl, self.cfg, self.traffic, self.cell = wl, cfg, traffic, cell
        self.seed, self.seconds, self.trace = int(seed), seconds, bool(trace)
        self.device, self.plant, self.guard = device, plant, guard
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.seeds = seeds_of(seed)
        self.clock = time.perf_counter
        self.ref = importlib.import_module(
            f"fedbench.reference.{cfg['family']}")

    # ------------------------------------------------------------ program

    def _check_modules(self, when):
        found = forbidden_modules() if self.guard else []
        if found:
            raise RuntimeError(f"{when}: loaded {found}; the benchmark runs "
                               "the PyTorch port without JAX")

    def setup(self):
        import torch
        from repro_torch.api import build_experiment
        fam = importlib.import_module(f"fedbench.families.{self.cfg['family']}")
        scn = fam.scenario(self.cfg, self.traffic, self.seeds, self.device)
        self.recorder = BatchRecorder(scn.client_batch_fn)
        scn.client_batch_fn = self.recorder
        if self.plant is not None:
            self.plant.scenario(scn)
        exp = build_experiment(
            self.traffic["algorithm"], scenario=scn,
            opt_kwargs=self.traffic["opt_kwargs"],
            **fed_overrides(self.traffic, self.seeds, self.device))
        del scn
        if self.plant is not None:
            self.plant.experiment(exp)
        p0 = {k: v.detach().to("cpu", copy=True)
              for k, v in flatten(exp.server.params)}
        prog = {"loss": [], "drift": []}
        self.setup_rounds = []
        for r in range(1, CHECK_ROUNDS + 1):
            t0 = time.perf_counter()
            rec = exp.run_round()
            self.setup_rounds.append(time.perf_counter() - t0)
            prog["loss"].append(float(rec["loss"]))
            prog["drift"].append(float(rec["drift"]))
            if r == 1:
                prog["grad"] = _norms(exp.server.g_global)
                prog["theta"] = _theta_norms(exp.server.theta)
        prog["change"] = {
            k: float(torch.linalg.vector_norm(
                v.detach().float() - p0[k].to(v.device)))
            for k, v in flatten(exp.server.params)}
        del p0
        exp.client_batch_fn = self.recorder.inner
        self.prog, self.exp = prog, exp
        self._check_modules("after set-up")

    def _round(self, exp):
        rec = exp.run_round()
        self.attempted += 1
        self.failed += not math.isfinite(rec["loss"])

    def window(self):
        import torch
        exp, dev = self.exp, torch.device(self.device)
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))
        sync()
        self.setup_s = time.perf_counter() - self.t_start
        self.attempted = self.failed = 0
        if self.trace:
            self._traced_rounds(exp, dev, sync)
        self.round_times = []
        t0 = self.clock()
        while True:
            elapsed = self.clock() - t0
            if self.round_times and (elapsed + max(self.round_times)
                                     > self.seconds):
                break
            t_r = self.clock()
            self._round(exp)
            self.round_times.append(self.clock() - t_r)
        sync()
        self.window_s = self.clock() - t0
        if self.trace:
            self.trace_ctx.timed_s = self.window_s
            self.trace_ctx.timed_rounds = len(self.round_times)
        self.memory_peak = (torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else 0)
        self.device_kind = (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")
        self._check_modules("after the window")

    def _traced_rounds(self, exp, dev, sync):
        """``TRACE_ROUNDS`` rounds under the profiler, with CUDA events
        around them; sets ``trace_ctx``."""
        import torch
        from repro_torch.obs import attach
        from torch.profiler import ProfilerActivity, profile
        sink = TimedSink()
        attach(exp, sink)
        marker = torch.zeros(1, device=dev)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        sync()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t_mark = time.perf_counter()
        marker.add_(1.0)                # the trace's first device op
        t0 = time.perf_counter()
        events[0].record()
        for _ in range(TRACE_ROUNDS):
            self._round(exp)
        events[1].record()
        sync()
        t1 = time.perf_counter()
        prof.stop()
        attach(exp)
        self.trace_ctx = self._trace_context(
            prof, sink, t_mark, t0, t1,
            events[0].elapsed_time(events[1]) * 1e-3)

    def _trace_context(self, prof, sink, t_mark, t0, t1, events_s):
        raw = devtrace.device_ops(prof)
        if not raw:
            raise RuntimeError("the profiler's trace holds no device "
                               "operation")
        # the marker is the trace's first device op, launched at t_mark:
        # it puts the device clock on the host's
        base = raw[0][1] - (t0 - t_mark) * 1e9
        ops = [devtrace.Op(n, (s - base) * 1e-9, d * 1e-9) for n, s, d in raw]
        return TraceContext(ops, sink.spans(t0), t1 - t0, TRACE_ROUNDS,
                            self.cfg, self.traffic, events_s=events_s)

    def free_program(self):
        import torch
        del self.exp
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- reference

    def reference(self, *, lowp=False, fault=None, micro_scale=1.0):
        """The reference's readings of the checked rounds (``micro_scale``
        scales its blocks of rows: the summation order alone)."""
        params = dict(flatten(make_weights(
            self.ref.weight_layout(self.cfg), self.seeds["weights"],
            self.device)))
        tr = self.traffic
        s, k = counts.cohort(tr), tr["local_steps"]
        micro = _micro(tr["batch_size"], s * self.ref.tokens_per_row(self.cfg),
                       int(self.cfg["reference_block_tokens"] * micro_scale))
        return run_rounds(
            lambda p, b: self.ref.loss(p, self.cfg, b, Precision(lowp)),
            params, self.recorder.rounds(s, k), algorithm=tr["algorithm"],
            lr=tr["lr"], beta=tr["beta"], server_lr=tr["server_lr"],
            opt_kwargs=tr["opt_kwargs"], prec=Precision(lowp),
            device=self.device, micro=micro, fault=fault)


class TraceContext:
    """What a per-layer metric's reader reads: the device operations of
    the traced window (seconds from its start), the program's spans, the
    window's length, the rounds traced, the cell's configuration and
    traffic for the work counts, the CUDA events' seconds around the traced
    rounds, and the untraced window's seconds and rounds (``timed_s``,
    ``timed_rounds``)."""

    def __init__(self, ops, spans, window_s, rounds, cfg, traffic, *,
                 events_s=None, timed_s=None, timed_rounds=None):
        self.ops, self.spans = ops, spans
        self.window_s, self.rounds = window_s, rounds
        self.cfg, self.traffic = cfg, traffic
        self.events_s = events_s
        self.timed_s, self.timed_rounds = timed_s, timed_rounds

    def group_seconds(self, group: str):
        """Device seconds of the operations of ``group``
        (``devtrace.group_of``) in the window; None if there is none."""
        ts = [o.dur for o in self.ops if devtrace.group_of(o.name) == group
              and 0.0 <= o.start <= self.window_s]
        return sum(ts) if ts else None

    def span_seconds(self, phase: str):
        ds = [d for name, _, d in self.spans if name == phase]
        return sum(ds) if ds else None

    def busy_seconds(self) -> float:
        return devtrace.busy_seconds(self.ops, 0.0, self.window_s)

    def events_share(self) -> float:
        """The trace's busy time over the CUDA events' time around the
        same rounds."""
        return self.busy_seconds() / self.events_s

    def breakdown(self) -> dict:
        return devtrace.breakdown(
            [o for o in self.ops if 0.0 <= o.start <= self.window_s],
            self.spans, 0.0, self.window_s)


END_TO_END = {
    "round_s": lambda run: run.window_s / len(run.round_times),
    "peak_mem_GiB": lambda run: run.memory_peak / 2**30,
    "setup_s": lambda run: run.setup_s,
}


def execute(manifest, wl, catalog, *, seed, seconds, trace, device="cuda",
            plant=None, t_start=None, guard=True, stream=None):
    """Run cell ``wl`` once; returns its result object.  The numbers
    compared with the reference are written to ``stream`` (standard error)
    last, each beside its limit."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 with TF32 off
    torch.backends.cudnn.allow_tf32 = False
    cfg = catalog.config(wl["config"])
    traffic = catalog.traffic(wl["traffic"])
    run = Run(wl, cfg, traffic, catalog.cell(wl["name"]), seed=seed,
              seconds=seconds, trace=trace, device=device, plant=plant,
              t_start=t_start, guard=guard)
    run.setup()
    run.window()
    stream = sys.stderr if stream is None else stream
    whole = True
    if trace:
        share = run.trace_ctx.events_share()
        whole = share >= TRACE_SHARE
        print(f"fedbench: the trace's busy time is {share!r} of the CUDA "
              f"events' {run.trace_ctx.events_s!r} s (least {TRACE_SHARE})"
              + ("" if whole else ": its device metrics are left out"),
              file=stream)
    metrics = {}
    for m in spec.reported(manifest, wl["name"], trace):
        if trace:
            if m.get("source") == "device_trace" and not whole:
                continue
            value = catalog.metric(m["name"]).read(run.trace_ctx)
        else:
            value = END_TO_END[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": run.device_kind, "count": wl["chips"],
           "memory_peak_bytes": run.memory_peak}
    if trace:
        dev.update(busy_s=run.trace_ctx.busy_seconds(),
                   window_s=run.trace_ctx.window_s)
    run.free_program()
    t_ref = time.perf_counter()
    vals = checks.values(run.prog, run.reference())
    t_ref = time.perf_counter() - t_ref
    ok, chk = checks.judge(vals, run.cell["limits"])
    result = {"correct": bool(ok and run.failed == 0),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = run.trace_ctx.breakdown()
        result["trace_share"] = {"value": share, "limit": TRACE_SHARE}
    result["checks"] = chk
    print(f"fedbench: set-up {run.setup_s} s (its rounds {run.setup_rounds} "
          f"s), window {run.window_s} s of rounds {run.round_times} s, "
          f"reference {t_ref} s; every number: {vals}", file=stream)
    for name, c in chk.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=stream)
    return result
