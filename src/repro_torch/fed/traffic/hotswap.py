"""Mid-stream algorithm hot-swap and A/B trace replay (counterpart of
``repro/fed/traffic/hotswap.py``).

``apply_swap`` rebinds a live :class:`TrafficExperiment` to a new
``AlgorithmSpec`` without stopping the stream: in-flight work trained
under the old algorithm is voided (its wire format no longer decodes) and
the aggregation buffer is discarded — both surface as traced
``client_dropped`` events with reason ``"algo_swap"`` — while the server
keeps its parameters and its **warm-started geometry** (the adaptive-beta
``GeometryController`` state carries over, so the new algorithm inherits
the drift estimate instead of relearning it).  The global preconditioner
reference Theta survives only when the new optimizer's preconditioner has
the identical tree structure and shapes; otherwise it restarts cold.

``run_ab`` replays one traffic trace against two independent experiments
(A/B): built with the same seeds they see the *same arrival stream* —
identical arrival times, client selections, latencies, and dropout fates —
so any divergence in their eval trajectories is attributable to the
algorithms, not the traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.utils.tree import tree_leaves


def _treedef(tree):
    """The structure of ``tree`` as ``jax.tree.structure`` sees it: dict
    keys (sorted), sequence lengths and kinds, ``None`` as an empty
    subtree, ``"*"`` at every leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _treedef(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_treedef(v) for v in tree))
    return "*"


def _same_structure(a, b) -> bool:
    if _treedef(a) != _treedef(b):
        return False
    return all(tuple(getattr(x, "shape", ())) == tuple(getattr(y, "shape", ()))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def apply_swap(exp, new_spec, *, opt_kwargs: Optional[dict] = None,
               sim_time: Optional[float] = None) -> None:
    """Swap the live algorithm of a running ``TrafficExperiment``.

    Voids every in-flight dispatch, discards the buffer (all traced with
    reason ``"algo_swap"``), rebinds the spec/optimizer/transport/step
    paths, and rebuilds the server state keeping params + g_global +
    geometry warm."""
    sched, t = exp.scheduler, exp.tracer
    for cid in list(sched._live_seq):
        seq = sched.void(cid)
        if seq is not None:
            exp._void_reason[seq] = "algo_swap"
    exp.discard_buffer(reason="algo_swap")

    old = exp.server
    exp._bind_spec(new_spec, old.params, opt_kwargs)
    theta = None
    if exp.align and old.theta is not None \
            and _same_structure(old.theta, exp._theta0):
        theta = old.theta            # same preconditioner geometry: keep it
    exp.server = dataclasses.replace(
        old, theta=theta,
        theta_version=old.theta_version if theta is not None else old.round)
    if t.enabled:
        t.emit("run_start", runtime="traffic",
               algorithm=exp.spec.name, swapped=True,
               sim_time=float(sim_time if sim_time is not None
                              else exp.sim_now))


def run_ab(exp_a, exp_b, *, sim_budget: Optional[float] = None,
           wall_budget: Optional[float] = None,
           max_flushes: Optional[int] = None) -> dict:
    """Replay one trace against two experiments under the same budgets.

    Build both with the same ``FedConfig.seed`` and trace config so their
    arrival streams coincide; one may carry a ``swap_to``/``swap_at`` for
    the mid-stream-swap arm.  Returns both summaries + eval histories."""
    sa = exp_a.run_stream(sim_budget=sim_budget, wall_budget=wall_budget,
                          max_flushes=max_flushes)
    sb = exp_b.run_stream(sim_budget=sim_budget, wall_budget=wall_budget,
                          max_flushes=max_flushes)
    return {"a": sa, "b": sb,
            "eval_a": list(exp_a.eval_history),
            "eval_b": list(exp_b.eval_history)}


def time_to_quality(eval_history, metric: str, target: float,
                    higher_is_better: bool = True) -> Optional[float]:
    """First simulated time at which ``metric`` crosses ``target`` in an
    anytime-eval history — the continuous-traffic headline number.  None
    if the target was never reached."""
    for rec in eval_history:
        v = rec.get(metric)
        if v is None:
            continue
        if (v >= target) if higher_is_better else (v <= target):
            return float(rec["sim_time"])
    return None
