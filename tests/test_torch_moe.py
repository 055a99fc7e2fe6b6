"""The port's MoE layer (``models/moe.py``), DeepSeek-V2's multi-head
latent attention (``models/attention.py::{init_mla, mla_forward,
init_mla_cache}``) and their two tables, Mixtral-8x22B and
DeepSeek-V2-236B, against the JAX package's: every field of the full and
reduced tables and ``num_params`` (shapes only, nothing allocated), the
assignment's shape table for all ten tables, ``moe_forward`` against the
reference and against a dense every-expert oracle, its gradients and
Sophia's jvp of grad against JAX's, the MoE under ``vmap(grad)`` over
clients against the per-client loop, on each reduced table the logits,
loss (with the router's aux) and gradients, prefill and decode, Mixtral's
ring-cache long decode, ``as_matrix``/``matrix_mask`` on stacked expert
leaves, and ``launch.serve`` on both tables.

The reference runs eagerly, but for three ``jax.jit`` compiles where its
op-by-op compiles cost most: each reduced table's forward, loss and
gradient in one, and the ring decode's step.  Each reduced table's
weights are drawn once for the file; they cross through
``repro_torch.convert`` and inputs are numpy from a seed.

Tolerances:
  * tables, counts, shapes and the matrix views: exact.
  * ``moe_forward`` against the dense oracle: 1e-4 absolute, the
    reference's own bound (tests/test_checkpoint_moe_rope.py); against
    the reference and the aux loss: 2e-5 absolute.
  * logits and loss 2e-5 absolute, gradients (and the jvp of grad) 1e-5 +
    1e-4 relative per element: tests/test_torch_lm.py's, in f32.
  * decode against the port's own forward: 2e-4, the reference's bound;
    prefill and decode logits against the reference's: 2e-5.
  * the routing decisions (each token's top-k experts) of every MoE
    layer: equal to the reference's.  The logits bounds above could not
    hold across a flipped choice, so they check it too.
  * the MoE under ``vmap`` against the per-client loop: bitwise.
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
from repro.models import moe as jax_moe
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.config import MoEConfig as JaxMoEConfig
from repro.models.param import Initializer as JaxInitializer
from repro.models.param import unbox
from repro.optim import api as jax_optim_api
from repro_torch import configs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import model, moe
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.optim import api as optim_api
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_leaves, tree_map,
)

LOGIT_TOL = 2e-5
DECODE_TOL = 2e-4
ORACLE_TOL = 1e-4
TABLES = ["mixtral-8x22b", "deepseek-v2-236b"]
# full num_params by the reference's count
NUM_PARAMS = {"mixtral-8x22b": 140_630_071_296,
              "deepseek-v2-236b": 235_576_284_160,
              "falcon-mamba-7b": 7_272_665_088,
              "recurrentgemma-2b": 2_894_574_080}
# tests/test_arch_smoke.py's table, all ten: layers, d_model, heads, kv
# heads, d_ff, vocab
SHAPES = {
    "starcoder2-3b": (30, 3072, 24, 2, 12288, 49152),
    "smollm-360m": (32, 960, 15, 5, 2560, 49152),
    "qwen2-vl-7b": (28, 3584, 28, 4, 18944, 152064),
    "musicgen-medium": (48, 1536, 24, 24, 6144, 2048),
    "deepseek-v2-236b": (60, 5120, 128, 128, 1536, 102400),
    "chatglm3-6b": (28, 4096, 32, 2, 13696, 65024),
    "mixtral-8x22b": (56, 6144, 48, 8, 16384, 32768),
    "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000),
    "falcon-mamba-7b": (64, 4096, 1, 1, 0, 65024),
    "qwen1.5-110b": (80, 8192, 64, 8, 49152, 152064),
}
# the reference's MoE unit config (tests/test_checkpoint_moe_rope.py)
UNIT = dict(name="t", num_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
            d_ff=32, vocab_size=64)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


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


@functools.lru_cache(maxsize=None)
def _setup(arch, **kw):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced table in f32, drawn once a file: the port's init (the
    reference's distributions and scales, from a host generator) carried
    into the reference's tree, whose leaves come in the same order."""
    jcfg = jax_configs.get_reduced(arch).replace(dtype="float32", **kw)
    tcfg = configs.get_reduced(arch).replace(dtype="float32", **kw)
    tparams = model.init_params(tcfg, torch.Generator().manual_seed(
        TABLES.index(arch)))
    jparams = jax.tree.unflatten(
        jax.tree.structure(jax_model.param_shapes(jcfg)),
        [jnp.asarray(a) for a in tree_leaves(params_to_numpy(tparams))])
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# --------------------------------------------------------------- tables

def test_full_tables_match_reference():
    for arch in TABLES:
        want, got = jax_configs.get_config(arch), configs.get_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert got.torch_dtype == torch.bfloat16
        assert dataclasses.asdict(configs.get_reduced(arch)) == \
            dataclasses.asdict(jax_configs.get_reduced(arch)), arch
        # shapes on the meta device: nothing allocated
        assert all(t.device.type == "meta" for _, t in
                   tree_flatten_with_path(model.param_shapes(got)))
        assert model.num_params(got) == jax_model.num_params(want) == \
            NUM_PARAMS[arch], arch
        red = configs.get_reduced(arch)
        assert model.num_params(red) == jax_model.num_params(
            jax_configs.get_reduced(arch))
    ds = configs.get_config("deepseek-v2-236b")
    assert (ds.moe.first_dense_layers, ds.moe.num_shared_experts,
            ds.moe.num_experts, ds.moe.top_k) == (1, 2, 160, 6)
    # the 2-layer cuts that the smoke serves at full width
    for arch, n in (("mixtral-8x22b", 5_410_781_184),
                    ("deepseek-v2-236b", 5_193_528_320)):
        cut = configs.get_config(arch).replace(num_layers=2)
        assert model.num_params(cut) == n


def test_shape_table_of_all_ten_matches_assignment():
    assert sorted(SHAPES) == sorted(configs.ASSIGNED)
    for arch, shape in SHAPES.items():
        for cfg in (configs.get_config(arch), jax_configs.get_config(arch)):
            assert (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.d_ff, cfg.vocab_size) == shape, arch


# ---------------------------------------------------------- the MoE layer

def _dense_oracle(p, x, cfg):
    """Every token's top-k experts, one token and one expert at a time
    (the reference's ``_dense_moe_oracle``)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf @ p["router"], dim=-1)
    topw, topi = torch.topk(probs, m.top_k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True)
    outs = []
    for t in range(xf.shape[0]):
        acc = torch.zeros(d)
        for j in range(m.top_k):
            e = int(topi[t, j])
            h = torch.nn.functional.silu(xf[t] @ p["w_gate"][e]) * (
                xf[t] @ p["w_up"][e])
            acc = acc + topw[t, j] * (h @ p["w_down"][e])
        outs.append(acc)
    y = torch.stack(outs)
    if m.num_shared_experts:
        from repro_torch.models.layers import apply_mlp
        y = y + apply_mlp(p["shared"], xf, "swiglu")
    return y.reshape(b, s, d)


def _unit(shared, seed):
    """(reference cfg, port cfg, reference params, port params, x)."""
    moe_kw = dict(num_experts=4, top_k=2, d_ff_expert=16,
                  num_shared_experts=shared)
    jcfg = JaxModelConfig(**UNIT, moe=JaxMoEConfig(**moe_kw))
    tcfg = ModelConfig(**UNIT, moe=MoEConfig(**moe_kw))
    jp = unbox(jax_moe.init_moe(
        JaxInitializer(jax.random.key(seed), jnp.float32), jcfg))
    x = np.random.default_rng(seed).standard_normal(
        (2, 6, 16)).astype(np.float32)
    return jcfg, tcfg, jp, _to_torch(jp), x


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_forward_matches_reference_and_dense_oracle(shared):
    jcfg, tcfg, jp, tp, x = _unit(shared, 5)
    want, waux = jax_moe.moe_forward(jp, jnp.asarray(x), jcfg)
    got, gaux = moe.moe_forward(tp, torch.from_numpy(x), tcfg)
    _close(got, want, LOGIT_TOL)
    assert abs(float(gaux) - float(waux)) <= LOGIT_TOL
    assert float(gaux) >= 0.0
    oracle = _dense_oracle(tp, torch.from_numpy(x), tcfg)
    assert float((got - oracle).abs().max()) < ORACLE_TOL
    # the routing decisions equal the reference's
    _, _, topi = moe._route(tp, torch.from_numpy(x).reshape(-1, 16), tcfg)
    jtop = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x).reshape(-1, 16) @ jp["router"], axis=-1), 2)[1]
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtop))


def test_moe_gradients_and_jvp_of_grad_match_jax():
    """Router and expert gradients of ``sum(y**2) + aux`` against
    ``jax.grad`` (non-zero, as the reference's own test asks), and
    Sophia's Hessian-vector product (``jvp`` of ``grad``) against JAX's."""
    jcfg, tcfg, jp, tp, x = _unit(1, 6)
    r = np.random.default_rng(7)
    u = jax.tree.map(lambda a: r.standard_normal(a.shape).astype(
        np.float32), jp)

    def jloss(p):
        y, aux = jax_moe.moe_forward(p, jnp.asarray(x), jcfg)
        return jnp.sum(y ** 2) + aux

    def tloss(p):
        y, aux = moe.moe_forward(p, torch.from_numpy(x), tcfg)
        return torch.sum(y ** 2) + aux

    wgrad = jax.grad(jloss)(jp)
    ggrad = torch.func.grad(tloss)(tp)
    _assert_tree_close(wgrad, ggrad)
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert float(ggrad[k].abs().sum()) > 0.0, k
    _, whvp = jax.jvp(jax.grad(jloss), (jp,), (u,))
    _, ghvp = torch.func.jvp(torch.func.grad(tloss), (tp,), (_to_torch(u),))
    _assert_tree_close(whvp, ghvp, atol=1e-4)


def test_moe_under_vmap_grad_equals_per_client_loop():
    """The client path's ``vmap(grad(...))`` over two clients with their
    own weights and tokens: the segment products' ``vmap`` rule loops
    over the clients, so each client's gradient is its own, bitwise."""
    _, tcfg, _, tp, x = _unit(1, 8)
    params = tree_map(lambda a: torch.stack([a, 1.5 * a]), tp)
    xs = torch.from_numpy(np.stack([x, -0.5 * x]))

    def loss(p, xx):
        y, aux = moe.moe_forward(p, xx, tcfg)
        return torch.sum(y ** 2) + aux

    batched = torch.func.vmap(torch.func.grad(loss))(params, xs)
    for c in range(2):
        one = torch.func.grad(loss)(tree_map(lambda a: a[c], params), xs[c])
        for (path, g), (_, w) in zip(tree_flatten_with_path(batched),
                                     tree_flatten_with_path(one)):
            assert torch.equal(g[c], w), (c, path)


# ------------------------------------------------------- reduced tables

@pytest.mark.parametrize("arch", TABLES)
def test_reduced_forward_loss_and_grad_match_reference(arch):
    """Logits, loss with the router's aux (summed over the MoE layers as
    the reference sums it) and gradients of every leaf, on the carried
    JAX weights.  Reduced DeepSeek: a dense layer 0 then a MoE layer with
    one shared expert, MLA at head dims 48 (q·k) and 32 (v)."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    toks = _tokens(tcfg, 1, 2, 16)
    batch = {"tokens": toks, "labels": np.ascontiguousarray(toks[:, ::-1])}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    @jax.jit
    def reference(p):
        logits, _, aux = jax_model.forward(p, jb, jcfg)
        return logits, aux, jax.value_and_grad(
            lambda q: jax_model.loss_fn(q, jb, jcfg))(p)

    wl, waux, (wloss, wgrad) = reference(jparams)
    gl, _, gaux = model.forward(tparams, tb, tcfg)
    _close(gl, wl, LOGIT_TOL)
    assert float(gaux) > 0 and abs(float(gaux) - float(waux)) <= LOGIT_TOL
    ggrad, gloss = torch.func.grad_and_value(
        lambda p: model.loss_fn(p, tb, tcfg))(tparams)
    assert abs(float(gloss) - float(wloss)) <= LOGIT_TOL
    _assert_tree_close(wgrad, ggrad)
    if arch == "deepseek-v2-236b":
        assert [len(g) for g in tparams["blocks"]] == [4, 4]   # dense, MoE
        assert "mlp" in tparams["blocks"][0] and \
            "shared" in tparams["blocks"][1]["moe"]
        assert tparams["blocks"][0]["mixer"]["wkv_b"].shape == (
            1, 64, 4 * (32 + 32))


@pytest.mark.parametrize("arch", TABLES)
def test_prefill_and_decode_match_forward_and_reference(arch):
    """Prefill 8 tokens into caches of 16 slots, then decode 4 more
    (teacher-forced): each step against the full forward at its position
    and against the reference's step; MLA's cache holds the latents
    only."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
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
            want, jcaches = jax_model.decode_step(
                jparams, jnp.asarray(toks[:, i:i + 1]), jcaches,
                jnp.int32(i), jcfg)
            _close(got, full[:, i], DECODE_TOL)
            _close(got, want, LOGIT_TOL)
    for g, w in zip(caches, jcaches):
        assert sorted(g) == sorted(w)
        np.testing.assert_array_equal(g["pos"].numpy(), np.asarray(w["pos"]))
        for k in g:
            assert tuple(g[k].shape) == w[k].shape
            _close(g[k], w[k], LOGIT_TOL)
    if tcfg.mla is not None:
        assert sorted(caches[0]) == ["c_kv", "k_rope", "pos"]
        assert caches[0]["c_kv"].shape == (1, b, s + 4, 64)


def test_mixtral_ring_cache_long_decode_matches_reference():
    """The reference's ``test_ring_cache_long_decode`` case: reduced
    Mixtral at window 8 decodes 20 steps from index 0 into ring caches of
    8 slots, step by step against the reference (the same tokens), and
    against the full windowed forward."""
    jcfg, tcfg, jparams, tparams = _setup("mixtral-8x22b", window=8)
    assert tcfg.supports_long_decode
    b, steps = 2, 20
    toks = _tokens(tcfg, 13, b, steps)
    tt = torch.from_numpy(toks)
    caches = model.init_caches(tcfg, b, max_len=64, ring=True)
    jcaches = jax_model.init_caches(jcfg, b, max_len=64, ring=True)
    assert caches[0]["k"].shape[2] == 8
    step = jax.jit(lambda p, t, c, i: jax_model.decode_step(p, t, c, i, jcfg))
    with torch.inference_mode():
        full = model.forward(tparams, {"tokens": tt}, tcfg)[0]
        for i in range(steps):
            got, caches = model.decode_step(tparams, tt[:, i:i + 1], caches,
                                            i, tcfg)
            want, jcaches = step(jparams, jnp.asarray(toks[:, i:i + 1]),
                                 jcaches, jnp.int32(i))
            _close(got, want, LOGIT_TOL)
            _close(got, full[:, i], DECODE_TOL)
            np.testing.assert_array_equal(caches[0]["pos"].numpy(),
                                          np.asarray(jcaches[0]["pos"]))
    assert bool(torch.isfinite(got).all())


# ------------------------------------------------- optimizer views, serve

@pytest.mark.parametrize("layers", [2, 9])
def test_as_matrix_and_matrix_mask_on_stacked_expert_leaves(layers):
    """A stacked expert leaf is ``(L, E, d, f)``.  With L <= 7 and E <= 7
    both packages read it as a conv kernel and flatten it to ``(L E d,
    f)``; deeper, they batch it as ``(L E, d, f)``.  ``lead`` keeps a
    cohort axis in front.  The router (E < 8 wide) and the norms go to the
    Adam fallback."""
    arch = "mixtral-8x22b"
    tcfg = configs.get_reduced(arch, layers=layers)
    jcfg = jax_configs.get_reduced(arch, layers=layers)
    shapes = model.param_shapes(tcfg)
    w = shapes["blocks"][0]["moe"]["w_gate"]
    assert tuple(w.shape) == (layers, 4, 256, 256)
    x = np.random.default_rng(0).standard_normal(
        (3, *w.shape)).astype(np.float32)
    for lead in (0, 1):
        xi = x if lead else x[0]
        got, orig = optim_api.as_matrix(torch.from_numpy(xi), lead)
        want, worig = jax_optim_api.as_matrix(jnp.asarray(x[0]))
        assert tuple(got.shape[lead:]) == want.shape
        assert orig == tuple(xi.shape) and tuple(worig) == w.shape
        np.testing.assert_array_equal(
            got.numpy() if not lead else got[0].numpy(), np.asarray(want))
    assert want.shape == ((layers * 4 * 256, 256) if layers <= 7
                          else (layers * 4, 256, 256))
    got_mask = {"/".join(map(str, p)): m for p, m in
                tree_flatten_with_path(optim_api.matrix_mask(shapes))}
    jshapes = jax_model.param_shapes(jcfg)
    want_mask = {jax_optim_api.path_str(p): m for p, m in
                 jax.tree_util.tree_flatten_with_path(
                     jax_optim_api.matrix_mask(jshapes))[0]}
    assert got_mask == want_mask
    assert not got_mask["blocks/0/moe/router"]
    assert got_mask["blocks/0/moe/w_down"]


@pytest.mark.parametrize("arch", TABLES)
def test_serve_main_reduced_on_cpu(arch):
    """``launch.serve`` on the reduced table: greedy tokens are the argmax
    of their logits, which match a full forward over prompt and tokens."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--gen", "4", "--device", "cpu"]
    out = serve.main(argv)
    cfg = out["cfg"]
    assert cfg.dtype == "float32" and cfg.moe is not None
    assert out["tokens"].shape == (2, 4)
    seq = torch.cat([out["prompt"], out["tokens"][:, :-1]], dim=1)
    with torch.inference_mode():
        full = model.forward(out["params"], {"tokens": seq}, cfg)[0]
    for i, lg in enumerate(out["logits"]):
        assert torch.equal(out["tokens"][:, i], torch.argmax(lg, dim=-1))
        _close(lg, full[:, 7 + i], DECODE_TOL)
