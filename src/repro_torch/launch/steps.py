"""Step functions run by the dry-run and by the train and serve scripts
(counterpart of ``repro/launch/steps.py``).

train_step  — one FedPAC local step: grad -> UpdateState -> P_Theta(g) ->
              correction mix with g_G (Eq. 9), with plain autograd
              (Sophia's Hessian-vector product by double backward).
fed_round   — a full Alg. 2 round: C client groups x K local steps (the
              port's cohort ``client_round`` under a cohort executor,
              its gradients from ``torch.func``) + parameter/Theta
              aggregation.  ``client_loop=True`` (the dry-run's route)
              runs the clients one after another with plain autograd
              instead, so that the round takes DTensors.
Both take ``remat`` (default True, the reference's): each layer is
recomputed in the backward (``models.transformer``).
prefill/decode — the serving paths.

The reference's ``unroll`` and ``layer_constraint`` are XLA knobs and are
not taken.  ``seq_shard`` (Megatron-style sequence sharding of the layer
input in the reference) redistributes a DTensor batch so that its
sequence dim is split over the "model" axis and its batch dim over
``batch_axes``; a plain tensor batch is left as it is.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.algorithms import resolve
from repro_torch.core.client import (
    LocalRunConfig, client_round, draw_probes, probe_generators,
    rademacher_like,
)
from repro_torch.core.engine import (
    AggregationConfig, ExecutorConfig, aggregate, make_cohort_executor,
)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.api import LocalOptimizer
from repro_torch.sharding.ops import is_dtensor
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

HESSIAN_FREQ = 10      # the reference train step's Sophia gate


def _seq_sharded(batch, batch_axes):
    """``batch`` with each DTensor entry's dim 0 over ``batch_axes`` and
    dim 1 (the sequence) over "model"; other entries unchanged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def one(x):
        if not isinstance(x, DTensor):
            return x
        names = x.device_mesh.mesh_dim_names
        placements = [Shard(0) if a in batch_axes else
                      Shard(1) if a == "model" and x.ndim > 1 else
                      Replicate() for a in names]
        return x.redistribute(x.device_mesh, placements)
    return {k: one(v) for k, v in batch.items()}


def make_loss_fn(cfg: ModelConfig, *, remat: bool = True,
                 seq_shard: bool = False, batch_axes=("data",)):
    def loss_fn(params, batch):
        if seq_shard:
            batch = _seq_sharded(batch, tuple(batch_axes))
        return M.loss_fn(params, batch, cfg, remat=remat)
    return loss_fn


def _hutchinson(loss, leaves, grads, probes):
    """u * (H u) per leaf by double backward: H u = d(g . u)/dx (H is
    symmetric), so a checkpointed (remat) layer recomputes once more
    instead of needing forward-mode AD."""
    dot = sum(torch.sum(g * u.to(g.dtype)) for g, u in zip(grads, probes))
    hvp = torch.autograd.grad(dot, leaves)
    return [u.to(torch.float32) * h.to(torch.float32)
            for u, h in zip(probes, hvp)]


def _local_step(loss_fn, opt, params, opt_state, g_global, batch, step, *,
                lr, beta, probes=None):
    """One FedPAC local step with plain autograd: grad -> UpdateState ->
    P_Theta(g) -> x - lr [(1-beta) d + beta g_G] (Eq. 9).  ``probes``
    (params-like), given on the steps that refresh an optimizer's
    curvature, feed Sophia's Hutchinson estimate by double backward.
    Returns (params, opt_state, loss)."""
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, create_graph=probes is not None)
    extras = None
    if probes is not None:
        est = _hutchinson(loss, leaves, grads, tree_leaves(probes))
        extras = {"h_est": tree_unflatten(params, est)}
        grads = [g.detach() for g in grads]
    direction, opt_state = opt.update(
        tree_unflatten(params, list(grads)), opt_state, params, step,
        extras=extras)

    def mix(d, gg, p):
        upd = (1.0 - beta) * d + beta * gg
        return (p.to(torch.float32) - lr * upd).to(p.dtype)

    return tree_map(mix, direction, g_global, params), opt_state, \
        loss.detach()


def make_train_step(cfg: ModelConfig, opt: LocalOptimizer, *, lr: float,
                    beta: float = 0.5, remat: bool = True,
                    seq_shard: bool = False, batch_axes=("data",)):
    """``train_step(params, opt_state, g_global, batch, step) -> (params,
    opt_state, loss)``.  Sophia refreshes its curvature on the steps with
    ``step % 10 == 0``, from Rademacher probes drawn by a generator on
    the params' device seeded with ``step``."""
    loss_fn = make_loss_fn(cfg, remat=remat, seq_shard=seq_shard,
                           batch_axes=batch_axes)

    def train_step(params, opt_state, g_global, batch, step):
        step = int(step)
        probes = None
        if opt.needs_hessian and step % HESSIAN_FREQ == 0:
            gen = torch.Generator(
                device=tree_leaves(params)[0].device).manual_seed(step)
            probes = rademacher_like(params, gen)
        return _local_step(loss_fn, opt, params, opt_state, g_global, batch,
                           step, lr=lr, beta=beta, probes=probes)

    return train_step


def _client_microbatch(x, c: int, k: int, clients: int, local_steps: int):
    """Client ``c``'s step-``k`` microbatch of a (B, ...) batch entry, as
    ``(C, K, B/(C K), ...)`` splits it.  A DTensor keeps its placements:
    its local rows split the same way, so each microbatch is sharded over
    the batch's mesh axes as the train step's batch is, and no collective
    moves a row (the global rows a client gets are then a permutation of
    the plain split's, which a fake run does not see)."""
    micro = x.shape[0] // (clients * local_steps)
    if not is_dtensor(x):
        return x.reshape(clients, local_steps, micro, *x.shape[1:])[c, k]
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    rows = local.shape[0] // (clients * local_steps)
    if rows * clients * local_steps != local.shape[0]:
        raise ValueError(
            f"a batch of {x.shape[0]} rows, {local.shape[0]} a rank, does "
            f"not split into {clients} clients x {local_steps} steps on "
            f"every rank")
    part = local.reshape(clients, local_steps, rows, *local.shape[1:])[c, k]
    shape = (micro, *x.shape[1:])
    return DTensor.from_local(
        part, x.device_mesh, x.placements, run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _looped_client_round(loss_fn, opt, run, x0, theta, g_global, batch,
                         clients: int, *, seed=0, probe_fn=None):
    """``client_round``'s (stacked delta, stacked Theta, mean loss) with
    the clients in a Python loop: each client's K local steps take their
    gradients from plain ``torch.autograd.grad`` (the train step's route;
    remat by ``torch.utils.checkpoint``), then the outputs are stacked on
    the client axis.  No ``torch.func``, so it takes DTensors.  Sophia's
    probes are ``client_round``'s: the stacked cohort's draw (or
    ``probe_fn(k)``), client ``c`` taking row ``c``."""
    k_steps = run.local_steps
    probes = {}
    if opt.needs_hessian:
        stacked = tree_map(lambda p: p.expand(clients, *p.shape), x0)
        gens = None if probe_fn is not None else probe_generators(
            seed, clients, tree_leaves(x0)[0].device)
        for k in range(0, k_steps, run.hessian_freq):
            probes[k] = (probe_fn(k) if probe_fn is not None
                         else draw_probes(stacked, gens))
    deltas, thetas, losses = [], [], []
    for c in range(clients):
        x = x0
        opt_state = opt.init(x0)
        if run.align and theta is not None:
            opt_state = opt.set_precond(opt_state, theta)
        for k in range(k_steps):
            micro = {name: _client_microbatch(b, c, k, clients, k_steps)
                     for name, b in batch.items() if b is not None}
            u = probes.get(k)
            x, opt_state, loss = _local_step(
                loss_fn, opt, x, opt_state, g_global, micro, k, lr=run.lr,
                beta=run.beta,
                probes=None if u is None else tree_map(lambda t: t[c], u))
            losses.append(loss)
        deltas.append(tree_map(
            lambda a, b: a.to(torch.float32) - b.to(torch.float32), x, x0))
        thetas.append(opt.get_precond(opt_state))

    def stack(*xs):
        return torch.stack(xs)
    return (tree_map(stack, *deltas), tree_map(stack, *thetas),
            torch.stack(losses).mean())


def make_fed_round_step(cfg: ModelConfig, opt: LocalOptimizer, *, lr: float,
                        beta: float = 0.5, clients: int = 8,
                        local_steps: int = 2, remat: bool = True,
                        seq_shard: bool = False, batch_axes=("data",),
                        algorithm=None, transport=None,
                        executor: Optional[ExecutorConfig] = None,
                        client_loop: bool = False):
    """Full FedPAC round: the global batch splits into ``clients`` cohorts
    of ``local_steps`` microbatches each; Theta/params aggregate through
    ``core.engine.aggregate``.

    ``algorithm`` (a registered name or an ``AlgorithmSpec``) supplies the
    alignment policy, the beta policy (``beta`` goes through
    ``spec.resolve_beta``) and per-client mixing weights; the default is
    FedPAC (align, uniform mixing, beta as given).  ``transport`` routes
    the delta and Theta uploads through their codecs' roundtrips before
    aggregation; the step keeps no state, so error feedback is rejected.
    ``executor`` maps the cohort onto the device (default ``vmap``).
    ``remat`` recomputes every layer of every client in the backward,
    under the cohort's ``torch.func`` transforms.

    ``client_loop=True`` replaces the cohort executor by a Python loop
    over the clients with plain autograd (``_looped_client_round``): the
    route that takes DTensors, which ``torch.func`` does not, for the
    dry-run.  On plain tensors it computes what the ``vmap`` route does,
    one client at a time."""
    if client_loop and executor is not None:
        raise ValueError("client_loop runs the cohort itself: pass no "
                         "executor")
    spec = resolve(algorithm) if algorithm is not None else None
    align = spec.align if spec is not None else True
    if spec is not None:
        beta = spec.resolve_beta(beta)
        if beta == "auto":
            raise ValueError(
                "beta='auto' needs the GeometryController round path "
                "(fed runtimes) — pass a float beta to make_fed_round_step")
    if transport is not None and transport.feedback_active:
        raise ValueError(
            "error feedback needs per-client residual state — use the fed "
            "runtimes (build_round_fn) or pass error_feedback=False")
    loss_fn = make_loss_fn(cfg, remat=remat, seq_shard=seq_shard,
                           batch_axes=batch_axes)
    run = LocalRunConfig(lr=lr, local_steps=local_steps, beta=beta,
                         align=align)
    agg_cfg = AggregationConfig(lr=lr, local_steps=local_steps, align=align)
    cohort_exec = None if client_loop else make_cohort_executor(executor)

    def fed_round(params, theta, g_global, batch, seed=0, probe_fn=None):
        """``seed`` seeds Sophia's probes (the reference's round key);
        ``probe_fn(k)`` replaces them (``client_round``'s)."""
        if client_loop:
            deltas, thetas, loss = _looped_client_round(
                loss_fn, opt, run, params, theta, g_global, batch, clients,
                seed=seed, probe_fn=probe_fn)
        else:
            def split(x):  # (B, ...) -> (C, K, B/(C*K), ...)
                micro = x.shape[0] // (clients * local_steps)
                return x.reshape(clients, local_steps, micro, *x.shape[1:])

            batches = {k: split(v) for k, v in batch.items()
                       if v is not None}
            deltas, thetas, loss = client_round(
                loss_fn, opt, run, params, theta, g_global, batches,
                cohort_exec, seed=seed, probe_fn=probe_fn)
        if transport is not None:
            deltas = transport.delta.roundtrip(deltas)
            if align:
                thetas = transport.theta.roundtrip(thetas)
        if spec is not None and spec.mixing is not None:
            weights = spec.mixing(deltas, thetas)
        else:
            weights = torch.ones((clients,), dtype=torch.float32,
                                 device=loss.device)
        new_params, new_theta, new_g, _ = aggregate(
            params, theta, g_global, deltas, thetas, weights, agg_cfg)
        return new_params, new_theta, new_g, loss

    return fed_round


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        return M.prefill(params, batch, cfg, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, index: int):
    def decode_step(params, tokens, caches):
        return M.decode_step(params, tokens, caches, index, cfg)
    return decode_step
