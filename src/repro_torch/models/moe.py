"""Mixture-of-Experts: top-k router and dropless sort-by-expert dispatch
(counterpart of ``repro/models/moe.py``).

The router is the reference's: softmax over the experts in f32, top-k,
the k weights renormalised to sum to 1, and the Switch load-balance aux
loss (``density`` from the top-1 choice, ``density_proxy`` the mean
probability).  Token-expert rows are sorted by expert with a stable sort
(``jnp.argsort`` is stable, so rows within a group keep the reference's
order), gathered, and run through each expert's SwiGLU MLP.

The reference's ``jax.lax.ragged_dot`` is an XLA op, not a Pallas kernel,
so the expert products here are plain ``torch.matmul`` over each
expert's contiguous segment of rows (``_RaggedDot``).  A segment loop
needs the group sizes on the host: a forward reads them once a MoE layer
(``group_sizes`` is copied to the host as it is counted; every product
of the layer and its backward then loop over that host copy).  The
products are ``torch.autograd.Function``s so that they compose with the
client path's ``torch.func`` transforms: a ``backward`` and a ``jvp``
built from the same two segment products (``dx = dy·Wᵀ``, ``dW_e =
x_eᵀ·dy_e``), so ``grad``, Sophia's ``jvp`` of ``grad`` and their
batched forms all work, and a ``vmap`` rule that loops over the batch
(the clients), since a batch of host sizes is not one loop.  The
alternative, every token through every expert and a mask, computes E/k
times the products (4x for Mixtral, ~27x for DeepSeek-V2's 160 experts
at top-6); the tests keep it as the oracle.

A fake or ``meta`` tensor (the dry-run, ``launch.dryrun``) has no
group sizes to read: there the rows split evenly over the experts
(``_even_sizes``), the work the reference's ``ragged_dot`` costs.  A real
tensor never takes that route.

The combine does not scatter-add (``index_add_`` on the card sums by
atomics, in no fixed order): each token has exactly ``top_k`` rows, so
the weighted rows are put back in token order as ``(T, k, d)`` and summed
over ``k`` in order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake, unset_fake_temporarily

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Initializer, apply_mlp, init_mlp


def init_moe(ini: Initializer, cfg: ModelConfig):
    m = cfg.moe
    d = cfg.d_model
    f = m.d_ff_expert
    p = {
        "router": ini.dense((d, m.num_experts), ("embed", "expert"),
                            scale=0.02),
        "w_gate": ini.dense((m.num_experts, d, f),
                            ("expert", "embed", "ffn")),
        "w_up": ini.dense((m.num_experts, d, f),
                          ("expert", "embed", "ffn")),
        "w_down": ini.dense((m.num_experts, f, d),
                            ("expert", "ffn", "embed")),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(ini, d, f * m.num_shared_experts, "swiglu")
    return p


# ------------------------------------------------------ segment products

def _segments(sizes):
    """[(expert, first row, end row)] of the non-empty groups; ``sizes``
    is a host tensor of rows per expert."""
    with unset_fake_temporarily():   # the shape-only route's real sizes
        counts = sizes.tolist()
    out, start = [], 0
    for e, n in enumerate(counts):
        if n:
            out.append((e, start, start + n))
        start += n
    return out


def _per_sample(info, in_dims, args):
    """The argument tuples of each sample of a vmapped call."""
    for b in range(info.batch_size):
        yield tuple(a if d is None else a.select(d, b)
                    for a, d in zip(args, in_dims))


def _add(a, b):
    return b if a is None else (a if b is None else a + b)


class _RaggedDot(torch.autograd.Function):
    """``y[rows of e] = x[rows of e] @ w[e]``: x (N, d) sorted by expert,
    w (E, d, f), sizes (E,) rows per expert on the host."""

    @staticmethod
    def forward(x, w, sizes):
        y = x.new_zeros((x.shape[0], w.shape[-1]))
        for e, a, b in _segments(sizes):
            y[a:b] = x[a:b] @ w[e]
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, w, sizes = ctx.saved_tensors
        dx = (_RaggedDot.apply(dy, w.transpose(-1, -2), sizes)
              if ctx.needs_input_grad[0] else None)
        dw = (_RaggedWeightGrad.apply(x, dy, sizes)
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None

    @staticmethod
    def jvp(ctx, dx, dw, _):
        x, w, sizes = ctx.saved_tensors
        return _add(None if dx is None else _RaggedDot.apply(dx, w, sizes),
                    None if dw is None else _RaggedDot.apply(x, dw, sizes))

    @staticmethod
    def vmap(info, in_dims, x, w, sizes):
        return torch.stack([_RaggedDot.apply(*a) for a in
                            _per_sample(info, in_dims, (x, w, sizes))]), 0


class _RaggedWeightGrad(torch.autograd.Function):
    """``g[e] = x[rows of e]ᵀ @ dy[rows of e]``: (E, d, f), zero for an
    expert with no rows."""

    @staticmethod
    def forward(x, dy, sizes):
        g = x.new_zeros((sizes.shape[0], x.shape[-1], dy.shape[-1]))
        for e, a, b in _segments(sizes):
            g[e] = x[a:b].transpose(0, 1) @ dy[a:b]
        return g

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, dg):
        x, dy, sizes = ctx.saved_tensors
        dx = (_RaggedDot.apply(dy, dg.transpose(-1, -2), sizes)
              if ctx.needs_input_grad[0] else None)
        ddy = (_RaggedDot.apply(x, dg, sizes)
               if ctx.needs_input_grad[1] else None)
        return dx, ddy, None

    @staticmethod
    def jvp(ctx, dx, ddy, _):
        x, dy, sizes = ctx.saved_tensors
        return _add(
            None if dx is None else _RaggedWeightGrad.apply(dx, dy, sizes),
            None if ddy is None else _RaggedWeightGrad.apply(x, ddy, sizes))

    @staticmethod
    def vmap(info, in_dims, x, dy, sizes):
        return torch.stack([_RaggedWeightGrad.apply(*a) for a in
                            _per_sample(info, in_dims, (x, dy, sizes))]), 0


def _ragged_expert_mlp(x_sorted, p, group_sizes):
    """x_sorted: (T*k, d) grouped by expert; SwiGLU expert MLP.
    ``group_sizes``: rows per expert, a host tensor."""
    g = _RaggedDot.apply(x_sorted, p["w_gate"], group_sizes)
    u = _RaggedDot.apply(x_sorted, p["w_up"], group_sizes)
    h = F.silu(g) * u
    return _RaggedDot.apply(h, p["w_down"], group_sizes)


# ------------------------------------------------------------- forward

def _shape_only(x) -> bool:
    """``x`` carries shapes but no values: a fake or ``meta`` tensor (a
    DTensor's local shard checked), as the dry-run runs the model."""
    local = getattr(x, "_local_tensor", x)
    return local.is_meta or is_fake(local)


def _even_sizes(rows: int, experts: int):
    """The shape-only route's group sizes: ``rows`` split as evenly as
    possible over the experts (the first ``rows % experts`` get one
    more), summing to ``rows``.  That is the work the reference's
    ``ragged_dot`` costs whatever the routing; a fake tensor has no
    routing to read."""
    base, extra = divmod(rows, experts)
    with unset_fake_temporarily():   # a real host tensor, as the read's
        return torch.tensor([base + (e < extra) for e in range(experts)])


def _route(p, xf, cfg: ModelConfig):
    """The router on tokens ``xf`` (T, d): (probs (T, E) in f32, top-k
    weights renormalised (T, k), top-k experts (T, k))."""
    logits = (xf @ p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, topw / torch.sum(topw, dim=-1, keepdim=True), topi


def moe_forward(p, x, cfg: ModelConfig):
    """x: (B,S,D) -> (B,S,D), aux_loss (router load-balance)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    probs, topw, topi = _route(p, xf, cfg)
    experts = torch.arange(m.num_experts, device=x.device)

    # load-balance aux loss (Switch-style)
    density = torch.mean((topi[:, :1] == experts).to(torch.float32), dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = (torch.sum(density * density_proxy) * m.num_experts
           * m.router_aux_coef)

    # sort token-expert assignments by expert id (stable, as jnp.argsort)
    flat_expert = topi.reshape(-1)  # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    token_of = order // m.top_k
    x_sorted = xf[token_of]  # (T*k, d)
    if _shape_only(flat_expert):
        group_sizes = _even_sizes(t * m.top_k, m.num_experts)
    else:
        # the one host read of the layer
        group_sizes = torch.sum(flat_expert[:, None] == experts,
                                dim=0).cpu()

    y_sorted = _ragged_expert_mlp(x_sorted, p, group_sizes)  # (T*k, d)
    w_sorted = topw.reshape(-1)[order]
    y_sorted = y_sorted * w_sorted[:, None].to(y_sorted.dtype)
    # back in token order, (T, k, d), summed over k in order
    rows = y_sorted[torch.argsort(order)].reshape(t, m.top_k, d)
    y = rows[:, 0]
    for j in range(1, m.top_k):
        y = y + rows[:, j]

    if m.num_shared_experts:
        y = y + apply_mlp(p["shared"], xf, "swiglu")
    return y.reshape(b, s, d), aux
