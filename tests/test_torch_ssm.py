"""The port's Mamba block (``models/ssm.py``), RG-LRU block
(``models/rglru.py``) and their two tables, Falcon-Mamba-7B and
RecurrentGemma-2B, against the JAX package's: every field of the full and
reduced tables and ``num_params`` (shapes only), the log-depth scan
against a loop over time and against ``jax.lax.associative_scan``, the
chunked scan's chunk choice at sequence lengths with no divisor near
``scan_chunk``, on each reduced table the logits, loss and gradients,
prefill and decode, the ring-cache long decode, a prefill into a
non-empty recurrent state (the reference's from-empty behaviour, pinned),
the blocks under ``vmap(grad)``, and ``launch.serve`` on both tables.

RecurrentGemma's ``reduced()`` table has 2 layers, both RG-LRU; its
decode tests take 3 layers, so that the ``local_attn`` layer of the
``(rglru, rglru, local_attn)`` pattern and its ring cache are in them.

The reference runs eagerly, but for ``jax.jit`` where its op-by-op
compiles (a new ``lax.scan`` over a group's layers at every decode step)
cost most: each reduced table's forward, loss and gradient in one
compile, and its ``decode_step`` (one compile for Falcon-Mamba, whose
O(1) caches have one shape; two for RecurrentGemma, whose local_attn
caches have 16 slots in the prefill test and 8 in the ring).  Weights are
the port's init carried into the reference's tree, inputs numpy from a
seed.

Tolerances: the scans associate in another order than JAX's
``associative_scan`` (log-depth from the left here, its odd/even
recursion there), so agreement is not bitwise.  It holds at
tests/test_torch_lm.py's f32 bounds all the same: logits and loss 2e-5
absolute, gradients 1e-5 + 1e-4 relative per element.  Decode against
the port's own forward: 2e-4 (the reference's bound); prefill and decode
logits against the reference's: 2e-5.  The caches: 2e-5 + 1e-4 relative
(the gradients' relative bound), since RecurrentGemma's local_attn K/V
come out of two RG-LRU layers and reach 2.3e-5 apart at 0.1.  The scan
against the loop and ``associative_scan``: 1e-5 relative.  The blocks
under ``vmap`` against the per-client loop: bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import model as jax_model
from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro_torch import configs
from repro_torch.convert import params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import model, rglru, ssm
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_leaves, tree_map,
)

LOGIT_TOL = 2e-5
DECODE_TOL = 2e-4
# the caches beside LOGIT_TOL: local_attn's K/V sit behind two RG-LRU
# layers whose scans associate in another order than the reference's
CACHE_RTOL = 1e-4
TABLES = ["falcon-mamba-7b", "recurrentgemma-2b"]
NUM_PARAMS = {"falcon-mamba-7b": 7_272_665_088,
              "recurrentgemma-2b": 2_894_574_080}
# the decode tests' RecurrentGemma: 3 layers, the local_attn one included,
# at the ring tests' window of 8
DECODE_KW = {"falcon-mamba-7b": {},
             "recurrentgemma-2b": {"layers": 3, "window": 8}}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _assert_tree_close(want, got, rtol=1e-4, atol=1e-5):
    w_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    g_leaves = tree_flatten_with_path(got)
    assert len(w_leaves) == len(g_leaves)
    for (wp, w), (gp, g) in zip(w_leaves, g_leaves):
        g = g.detach().numpy()
        assert np.asarray(w).shape == g.shape, (wp, gp)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=str(gp))


def _to_jax(tree, like):
    """The port's tree as the reference's, whose leaves come in the same
    order."""
    return jax.tree.unflatten(jax.tree.structure(like), [
        jnp.asarray(a) for a in tree_leaves(params_to_numpy(tree))])


@functools.lru_cache(maxsize=None)
def _setup(arch, layers=2, **kw):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced table in f32, drawn once a file by the port's init and
    carried into the reference's tree."""
    jcfg = jax_configs.get_reduced(arch, layers=layers).replace(
        dtype="float32", **kw)
    tcfg = configs.get_reduced(arch, layers=layers).replace(
        dtype="float32", **kw)
    tparams = model.init_params(tcfg, torch.Generator().manual_seed(
        TABLES.index(arch)))
    return jcfg, tcfg, _to_jax(tparams, jax_model.param_shapes(jcfg)), \
        tparams


@functools.lru_cache(maxsize=None)
def _reference_step(jcfg):
    """The reference's ``decode_step`` under ``jax.jit``, one a table."""
    return jax.jit(lambda p, t, c, i: jax_model.decode_step(p, t, c, i,
                                                            jcfg))


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _mixer(arch, tcfg, tparams, group=0, layer=0):
    """One layer's mixer weights (port) and its forward of both
    packages."""
    p = tree_map(lambda a: a[layer], tparams["blocks"][group]["mixer"])
    if arch == "falcon-mamba-7b":
        return p, ssm.mamba_forward, jax_ssm.mamba_forward
    return p, rglru.rglru_forward, jax_rglru.rglru_forward


# --------------------------------------------------------------- tables

def test_full_tables_match_reference():
    for arch in TABLES:
        want, got = jax_configs.get_config(arch), configs.get_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert dataclasses.asdict(configs.get_reduced(arch)) == \
            dataclasses.asdict(jax_configs.get_reduced(arch)), arch
        assert all(t.device.type == "meta" for _, t in
                   tree_flatten_with_path(model.param_shapes(got)))
        assert model.num_params(got) == jax_model.num_params(want) == \
            NUM_PARAMS[arch], arch
        assert got.supports_long_decode
    rg = configs.get_config("recurrentgemma-2b")
    assert (rg.block_pattern, rg.window, rg.n_kv_heads, rg.head_dim,
            rg.mlp_type, rg.tie_embeddings, rg.rglru.c) == (
        ("rglru", "rglru", "local_attn"), 2048, 1, 256, "geglu", True, 8.0)
    fm = configs.get_config("falcon-mamba-7b")
    assert fm.is_attention_free and fm.d_ff == 0 and fm.ssm.scan_chunk == 128
    # a Mamba layer has no post-norm MLP
    assert sorted(model.param_shapes(configs.get_reduced(
        "falcon-mamba-7b"))["blocks"][0]) == ["mixer", "pre_norm"]


# ----------------------------------------------------------------- scans

def test_scan_pairs_matches_loop_and_associative_scan():
    r = np.random.default_rng(0)
    for n in (1, 5, 16, 37):
        a = r.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
        b = r.standard_normal((2, n, 3)).astype(np.float32)
        pa, h = ssm.scan_pairs(torch.from_numpy(a), torch.from_numpy(b), 1)
        want, acc = np.zeros_like(b), np.zeros((2, 3), np.float32)
        for t in range(n):
            acc = a[:, t] * acc + b[:, t]
            want[:, t] = acc
        np.testing.assert_allclose(h.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pa.numpy(), np.cumprod(a, axis=1),
                                   rtol=1e-5)

        def combine(e1, e2):
            return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

        ja, jh = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                    jnp.asarray(b)), axis=1)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("s,chunk", [(34, 2), (17, 1), (48, 16)])
def test_chunk_choice_matches_reference(s, chunk, monkeypatch):
    """The chunk is the largest divisor of ``s`` that is at most
    ``scan_chunk`` (16 reduced), with no padding: 34 runs as 17 chunks of
    2, the prime 17 as 17 chunks of 1.  The block's output and last state
    against the reference's on the same ``s``."""
    arch = "falcon-mamba-7b"
    jcfg, tcfg, _, tparams = _setup(arch)
    p, fwd, jfwd = _mixer(arch, tcfg, tparams)
    seen = []
    inner = ssm.scan_pairs

    def spy(a, b, dim):
        seen.append(a.shape[dim])
        return inner(a, b, dim)

    monkeypatch.setattr(ssm, "scan_pairs", spy)
    x = np.random.default_rng(s).standard_normal(
        (2, s, tcfg.d_model)).astype(np.float32)
    cache = ssm.init_mamba_cache(tcfg, 2, torch.float32)
    got, _ = fwd(p, torch.from_numpy(x), tcfg, cache=cache)
    assert seen == [chunk] * (s // chunk)
    jp = _to_jax(p, p)
    want, wcache = jfwd(jp, jnp.asarray(x), jcfg,
                        cache=jax_ssm.init_mamba_cache(jcfg, 2, jnp.float32))
    _close(got, want, LOGIT_TOL)
    _close(cache["ssm"], wcache["ssm"], LOGIT_TOL)
    _close(cache["conv"], wcache["conv"], LOGIT_TOL)


# ------------------------------------------------------- reduced tables

@pytest.mark.parametrize("arch", TABLES)
def test_reduced_forward_loss_and_grad_match_reference(arch):
    """Logits, loss and the gradient of every leaf on the carried
    weights, over 20 tokens (the Mamba scan in 2 chunks of 10)."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    toks = _tokens(tcfg, 1, 2, 20)
    batch = {"tokens": toks, "labels": np.ascontiguousarray(toks[:, ::-1])}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    @jax.jit
    def reference(p):
        return jax_model.forward(p, jb, jcfg)[0], jax.value_and_grad(
            lambda q: jax_model.loss_fn(q, jb, jcfg))(p)

    wl, (wloss, wgrad) = reference(jparams)
    gl = model.forward(tparams, tb, tcfg)[0]
    _close(gl, wl, LOGIT_TOL)
    ggrad, gloss = torch.func.grad_and_value(
        lambda p: model.loss_fn(p, tb, tcfg))(tparams)
    assert abs(float(gloss) - float(wloss)) <= LOGIT_TOL
    _assert_tree_close(wgrad, ggrad)


@pytest.mark.parametrize("arch", TABLES)
def test_prefill_and_decode_match_forward_and_reference(arch):
    """Prefill 8 tokens into caches of 16 slots, then decode 4 more
    (teacher-forced): each step against the full forward at its position
    and against the reference's step, and the O(1) states (and the
    local_attn K/V) against the reference's caches."""
    jcfg, tcfg, jparams, tparams = _setup(arch, **DECODE_KW[arch])
    step = _reference_step(jcfg)
    b, s, pre = 2, 12, 8
    toks = _tokens(tcfg, 7, b, s)
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        full = model.forward(tparams, {"tokens": tt}, tcfg)[0]
        got, caches = model.prefill(tparams, {"tokens": tt[:, :pre]}, tcfg,
                                    max_len=s + 4)
        want, jcaches = jax_model.prefill(
            jparams, {"tokens": jnp.asarray(toks[:, :pre])}, jcfg,
            max_len=s + 4)
        _close(got, full[:, pre - 1], DECODE_TOL)
        _close(got, want, LOGIT_TOL)
        for i in range(pre, s):
            got, caches = model.decode_step(tparams, tt[:, i:i + 1], caches,
                                            i, tcfg)
            want, jcaches = step(jparams, jnp.asarray(toks[:, i:i + 1]),
                                 jcaches, jnp.int32(i))
            _close(got, full[:, i], DECODE_TOL)
            _close(got, want, LOGIT_TOL)
    kinds = [sorted(c) for c in caches]
    assert kinds == ([["conv", "ssm"]] if arch == "falcon-mamba-7b" else
                     [["conv", "h"], ["k", "pos", "v"]])
    for g, w in zip(caches, jcaches):
        assert sorted(g) == sorted(w)
        for k in g:
            assert tuple(g[k].shape) == w[k].shape
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=LOGIT_TOL, rtol=CACHE_RTOL)


@pytest.mark.parametrize("arch", TABLES)
def test_ring_cache_long_decode_matches_reference(arch):
    """The reference's ``test_ring_cache_long_decode`` cases: the reduced
    table (RecurrentGemma at 3 layers, its local_attn at window 8)
    decodes 20 steps from index 0 into ring caches, step by step against
    the reference and against the full forward."""
    jcfg, tcfg, jparams, tparams = _setup(arch, **DECODE_KW[arch])
    step = _reference_step(jcfg)
    assert tcfg.supports_long_decode
    b, steps = 2, 20
    toks = _tokens(tcfg, 13, b, steps)
    tt = torch.from_numpy(toks)
    caches = model.init_caches(tcfg, b, max_len=64, ring=True)
    jcaches = jax_model.init_caches(jcfg, b, max_len=64, ring=True)
    with torch.inference_mode():
        full = model.forward(tparams, {"tokens": tt}, tcfg)[0]
        for i in range(steps):
            got, caches = model.decode_step(tparams, tt[:, i:i + 1], caches,
                                            i, tcfg)
            want, jcaches = step(jparams, jnp.asarray(toks[:, i:i + 1]),
                                 jcaches, jnp.int32(i))
            _close(got, want, LOGIT_TOL)
            _close(got, full[:, i], DECODE_TOL)
    if arch == "recurrentgemma-2b":
        assert caches[1]["k"].shape[2] == 8
        np.testing.assert_array_equal(caches[1]["pos"].numpy(),
                                      np.asarray(jcaches[1]["pos"]))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("arch", TABLES)
def test_prefill_into_nonempty_state_starts_from_empty(arch):
    """A forward over 4 tokens with a cache that already holds a state:
    both packages zero-pad the conv and start the scan at h = 0, ignoring
    the state (a chunked prefill that continues a cache is wrong in the
    reference too); the new cache takes the old conv tail and the scan's
    last state."""
    jcfg, tcfg, _, tparams = _setup(arch)
    p, fwd, jfwd = _mixer(arch, tcfg, tparams)
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 4, tcfg.d_model)).astype(np.float32)
    init = (ssm.init_mamba_cache if arch == "falcon-mamba-7b"
            else rglru.init_rglru_cache)(tcfg, 2, torch.float32)
    state = {k: r.standard_normal(v.shape).astype(np.float32)
             for k, v in init.items()}
    cache = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    got, _ = fwd(p, torch.from_numpy(x), tcfg, cache=cache)
    fresh, _ = fwd(p, torch.from_numpy(x), tcfg)
    assert torch.equal(got, fresh)
    want, wcache = jfwd(_to_jax(p, p), jnp.asarray(x), jcfg,
                        cache={k: jnp.asarray(v) for k, v in state.items()})
    _close(got, want, LOGIT_TOL)
    for k in cache:
        _close(cache[k], wcache[k], LOGIT_TOL)
    tail = np.concatenate([state["conv"], np.asarray(
        x @ p["in_proj"].numpy())[..., :state["conv"].shape[-1]]], axis=1)
    _close(cache["conv"], tail[:, -3:], 1e-5)


@pytest.mark.parametrize("arch", TABLES)
def test_blocks_under_vmap_grad_equal_per_client_loop(arch):
    """The client path's ``vmap(grad(...))`` over two clients through the
    log-depth scans: each client's gradient is its own, bitwise."""
    _, tcfg, _, tparams = _setup(arch)
    p, fwd, _ = _mixer(arch, tcfg, tparams)
    params = tree_map(lambda a: torch.stack([a, 0.9 * a]), p)
    xs = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 2, 20, tcfg.d_model)).astype(np.float32))

    def loss(q, xx):
        return torch.sum(fwd(q, xx, tcfg)[0] ** 2)

    batched = torch.func.vmap(torch.func.grad(loss))(params, xs)
    for c in range(2):
        one = torch.func.grad(loss)(tree_map(lambda a: a[c], params), xs[c])
        for (path, g), (_, w) in zip(tree_flatten_with_path(batched),
                                     tree_flatten_with_path(one)):
            assert torch.equal(g[c], w), (c, path)


@pytest.mark.parametrize("arch", TABLES)
def test_serve_main_reduced_on_cpu(arch):
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--gen", "4", "--device", "cpu"]
    out = serve.main(argv)
    cfg = out["cfg"]
    assert cfg.dtype == "float32" and cfg.supports_long_decode
    assert out["tokens"].shape == (2, 4)
    seq = torch.cat([out["prompt"], out["tokens"][:, :-1]], dim=1)
    with torch.inference_mode():
        full = model.forward(out["params"], {"tokens": seq}, cfg)[0]
    for i, lg in enumerate(out["logits"]):
        assert torch.equal(out["tokens"][:, i], torch.argmax(lg, dim=-1))
        _close(lg, full[:, 7 + i], DECODE_TOL)
