"""Step functions run by the dry-run and by the train and serve scripts
(counterpart of ``repro/launch/steps.py``).

train_step  — one FedPAC local step: grad -> UpdateState -> P_Theta(g) ->
              correction mix with g_G (Eq. 9), with plain autograd
              (Sophia's Hessian-vector product by double backward).
fed_round   — a full Alg. 2 round: C client groups x K local steps (the
              port's cohort ``client_round`` under a cohort executor,
              its gradients from ``torch.func``) + parameter/Theta
              aggregation.
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
    LocalRunConfig, client_round, rademacher_like,
)
from repro_torch.core.engine import (
    AggregationConfig, ExecutorConfig, aggregate, make_cohort_executor,
)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.api import LocalOptimizer
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
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        gate = opt.needs_hessian and step % HESSIAN_FREQ == 0
        grads = torch.autograd.grad(loss, leaves, create_graph=gate)
        extras = None
        if gate:
            gen = torch.Generator(device=leaves[0].device).manual_seed(step)
            probes = tree_leaves(rademacher_like(params, gen))
            est = _hutchinson(loss, leaves, grads, probes)
            extras = {"h_est": tree_unflatten(params, est)}
            grads = [g.detach() for g in grads]
        direction, opt_state = opt.update(
            tree_unflatten(params, list(grads)), opt_state, params,
            step, extras=extras)

        def mix(d, gg, p):
            upd = (1.0 - beta) * d + beta * gg
            return (p.to(torch.float32) - lr * upd).to(p.dtype)

        params = tree_map(mix, direction, g_global, params)
        return params, opt_state, loss.detach()

    return train_step


def make_fed_round_step(cfg: ModelConfig, opt: LocalOptimizer, *, lr: float,
                        beta: float = 0.5, clients: int = 8,
                        local_steps: int = 2, remat: bool = True,
                        seq_shard: bool = False, batch_axes=("data",),
                        algorithm=None, transport=None,
                        executor: Optional[ExecutorConfig] = None):
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
    under the cohort's ``torch.func`` transforms."""
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
    cohort_exec = make_cohort_executor(executor)

    def fed_round(params, theta, g_global, batch, seed=0, probe_fn=None):
        """``seed`` seeds Sophia's probes (the reference's round key);
        ``probe_fn(k)`` replaces them (``client_round``'s)."""
        def split(x):  # (B, ...) -> (C, K, B/(C*K), ...)
            micro = x.shape[0] // (clients * local_steps)
            return x.reshape(clients, local_steps, micro, *x.shape[1:])

        batches = {k: split(v) for k, v in batch.items() if v is not None}
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
