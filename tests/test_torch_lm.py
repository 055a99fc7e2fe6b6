"""The port's LM path (``repro_torch.models.{config,layers,rope,attention,
transformer,model}``, ``repro_torch.configs`` and the ``lm_zipf`` family)
against the JAX package's: the corpus, batches and partitions (numpy
copies: bitwise), the configs and parameter counts, rope with a partial
fraction and M-RoPE sections, the chunked online-softmax attention,
logits, loss and gradients of the transformer LM on the carried-across
JAX weights (the ``lm_zipf`` tiny shape, a GQA config, a windowed config
and an untied LayerNorm/GELU/bias config), the checkpoint key strings of
the LM params and of SOAP's Theta, and 3-round ``lm_zipf`` histories of
``fedpac_soap`` (eps=1e-3), ``fedpac_sophia`` (the reference's probes
injected) and ``fedpac_muon``.

Tolerances:
  * data, partitions, batches, configs, counts and key strings: exact.
  * rope and attention: 1e-6 absolute (f32 sums in other orders).
  * logits and loss 2e-5 absolute, gradients 1e-5 + 1e-4 relative per
    element: the ViT's (tests/test_torch_models.py).
  * histories: SOAP's round tolerances at eps=1e-3
    (tests/test_torch_round.py: loss 5e-3, eval loss 2e-2, token accuracy
    6/768, drift and norm_drift 5% relative), Sophia's with the
    reference's probes (tests/test_torch_sophia.py) and Muon's
    (tests/test_torch_muon.py): loss and eval loss 1e-4, token accuracy
    2/768, drift and norm_drift 1e-3 relative.  The eval loss and token
    accuracy take the vision scenarios' test_loss and test_acc limits.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.api import build_experiment as jax_build
from repro.checkpoint import store as jax_store
from repro.data import synth as jax_synth
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models import rope as jax_rope
from repro.optim import soap as jax_soap
from repro.scenarios import materialize as jax_materialize
from repro_torch import configs
from repro_torch.api import build_experiment, materialize
from repro_torch.checkpoint import store
from repro_torch.convert import params_from_numpy
from repro_torch.core.algorithms import build_round_fn, zero_theta
from repro_torch.data import synth
from repro_torch.models import attention, model, rope, transformer
from repro_torch.models.layers import Initializer
from repro_torch.optim import soap
from repro_torch.optim.api import matrix_mask
from repro_torch.utils.tree import (
    tree_flatten_with_path, tree_leaves, tree_map_with_path,
)

ROUNDS = 3
SOAP_TOL = {"loss": 5e-3, "eval_loss": 2e-2, "token_acc": 6 / 768}
SOAP_REL_TOL = {"drift": 0.05, "norm_drift": 0.05}
TIGHT_TOL = {"loss": 1e-4, "eval_loss": 1e-4, "token_acc": 2 / 768}
TIGHT_REL_TOL = {"drift": 1e-3, "norm_drift": 1e-3}
LOGIT_TOL = 2e-5

# the lm_zipf tiny shape: 2 layers, d_model 64, vocab 256, seq 32
TINY = dict(layers=2, d_model=64, vocab=256)
CONFIGS = {
    "lm_zipf": {},
    "gqa": dict(n_heads=4, n_kv_heads=2, head_dim=16),
    "windowed": dict(block_pattern=("swa", "swa", "attn"), num_layers=3,
                     window=8),
    "untied_layer_gelu_bias": dict(tie_embeddings=False, norm_type="layer",
                                   mlp_type="gelu", qkv_bias=True,
                                   rope_fraction=0.5),
}


def _cfgs(name):
    """(reference config, port config) of one parity case."""
    kw = CONFIGS[name]
    want = jax_configs.get_reduced("llama-60m", **TINY).replace(**kw)
    got = configs.get_reduced("llama-60m", **TINY).replace(**kw)
    return want, got


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(want, got, rtol=1e-4, atol=1e-5):
    w_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    g_leaves = tree_flatten_with_path(got)
    assert len(w_leaves) == len(g_leaves)
    for (wp, w), (gp, g) in zip(w_leaves, g_leaves):
        g = g.detach().numpy()
        assert np.asarray(w).shape == g.shape, (wp, gp)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=str(gp))


# ------------------------------------------------------------------ data

def test_lm_corpus_and_batches_match_reference():
    want = jax_synth.make_lm_topic_corpus(40, 120, vocab=97, n_topics=5,
                                          seed=3)
    got = synth.make_lm_topic_corpus(40, 120, vocab=97, n_topics=5, seed=3)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    stream = got[0].reshape(-1)
    for w, g in zip(jax_synth.lm_batches(stream, seq_len=16, batch=4,
                                         steps=3, seed=1),
                    synth.lm_batches(stream, seq_len=16, batch=4, steps=3,
                                     seed=1)):
        np.testing.assert_array_equal(g, w)
    for w, g in zip(jax_synth.make_lm_corpus(3, 50, vocab=64, hetero=0.7,
                                             seed=2),
                    synth.make_lm_corpus(3, 50, vocab=64, hetero=0.7,
                                         seed=2)):
        np.testing.assert_array_equal(g, w)
    for mod in (jax_synth, synth):
        with pytest.raises(ValueError, match="hetero"):
            mod.make_lm_corpus(2, 5, hetero=1.5)
        with pytest.raises(ValueError, match="longer"):
            mod.lm_batches(np.arange(5), seq_len=8, batch=1, steps=1)


@pytest.mark.parametrize("name", ["lm_zipf", "lm_zipf_dir0.05",
                                  "lm_zipf_shard", "lm_zipf_iid"])
def test_materialize_lm_matches_reference(name):
    want = jax_materialize(name, seed=2)
    got = materialize(name, seed=2, device="cpu")
    assert got.n_clients == want.n_clients == 8
    assert len(got.partitions) == len(want.partitions)
    for w, g in zip(want.partitions, got.partitions):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got.partition_stats["tokens_per_client"] == \
        want.partition_stats["tokens_per_client"]
    for cid in (0, 5):
        rw, rg = np.random.default_rng(cid), np.random.default_rng(cid)
        for _ in range(2):
            bw, bg = want.client_batch_fn(cid, rw), got.client_batch_fn(cid,
                                                                       rg)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(np.asarray(bg[k]),
                                              np.asarray(bw[k]))
    assert got.meta["model_cfg"] == configs.get_reduced(
        "llama-60m", **TINY).replace(dtype="float32")
    assert getattr(got.client_batch_fn, "_repro_thread_safe", False)
    # the parameter tree's keys and shapes are the reference's
    assert list(store._flatten(got.params)) == \
        list(jax_store._flatten(want.params))
    for w, g in zip(jax.tree.leaves(want.params), tree_leaves(got.params)):
        assert tuple(g.shape) == w.shape


# --------------------------------------------------------------- configs

def test_configs_match_reference():
    assert configs.ALL == jax_configs.ALL
    assert configs.ASSIGNED == jax_configs.ASSIGNED
    for name in ("llama-60m", "llama-130m", "llama-350m"):
        want, got = jax_configs.get_config(name), configs.get_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.torch_dtype == torch.float32
        red_w = jax_configs.get_reduced(name, layers=3, d_model=96)
        red_g = configs.get_reduced(name, layers=3, d_model=96)
        assert dataclasses.asdict(red_g) == dataclasses.asdict(red_w)
        for w, g in ((want, got), (red_w, red_g)):
            assert model.num_params(g) == jax_model.num_params(w)
    # LLaMA-60M at full width: 8 layers of d 512, d_ff 1376, tied vocab
    assert model.num_params(configs.get_config("llama-60m")) == 41_689_600
    # every table loads, each equal to the reference's (tests/test_torch_
    # arch.py, test_torch_moe.py and test_torch_ssm.py hold their counts)
    for name in configs.ALL:
        assert dataclasses.asdict(configs.get_config(name)) == \
            dataclasses.asdict(jax_configs.get_config(name)), name


def test_param_tree_and_matrix_leaves():
    """The stacked (layers, m, n) matrices are SOAP's and Muon's domain:
    7 hidden matrices, 4 Adam-fallback leaves (embedding, two stacked
    norms, final norm) — the leaves LLaMA-60M's SOAP step counts."""
    cfg = configs.get_config("llama-60m")
    shapes = model.param_shapes(cfg)
    mask = matrix_mask(shapes)
    flat = {"/".join(map(str, p)): (tuple(s.shape), m) for (p, s), (_, m)
            in zip(tree_flatten_with_path(shapes),
                   tree_flatten_with_path(mask))}
    assert {k for k, (_, m) in flat.items() if m} == {
        f"blocks/0/{k}" for k in ("mixer/wq", "mixer/wk", "mixer/wv",
                                  "mixer/wo", "mlp/w_gate", "mlp/w_up",
                                  "mlp/w_down")}
    assert {k for k, (_, m) in flat.items() if not m} == {
        "embed/tok", "blocks/0/pre_norm/scale", "blocks/0/post_norm/scale",
        "final_norm/scale"}
    assert flat["blocks/0/mlp/w_down"][0] == (8, 1376, 512)
    assert flat["embed/tok"][0] == (32000, 512)
    windowed = _cfgs("windowed")[1]
    assert transformer.layer_groups(windowed) == \
        [(0, 2, ("swa", False)), (2, 1, ("attn", False))]
    with pytest.raises(ValueError, match="conv"):
        transformer.init_layer(Initializer(None), windowed, "conv", False)
    p = model.init_params(_cfgs("lm_zipf")[1], torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32)}
    # remat: the same loss under plain autograd, a stated limit under a
    # torch.func transform
    cfg = _cfgs("lm_zipf")[1]
    assert torch.equal(model.loss_fn(p, batch, cfg, remat=True),
                       model.loss_fn(p, batch, cfg))
    with pytest.raises(NotImplementedError, match="torch.func"):
        torch.func.grad(lambda q: model.loss_fn(q, batch, cfg,
                                                remat=True))(p)


# ------------------------------------------------------------ rope, sdpa

@pytest.mark.parametrize("case", ["full", "fraction", "mrope"])
def test_rope_matches_reference(case):
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 3, (2, 7))
    kw = {}
    if case == "fraction":
        kw = dict(fraction=0.5, theta=500.0)
    elif case == "mrope":
        pos = np.stack([pos, pos * 2, pos + 5], -1).astype(np.int32)
        kw = dict(mrope_sections=(4, 2, 2))
    want = jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), **kw)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                          **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    if case == "mrope":   # the text-only path of an M-RoPE model
        w = jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos))
        g = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("window, chunk, hkv", [(0, 8, 4), (5, 6, 2),
                                                (0, 16, 1)])
def test_chunked_sdpa_matches_sdpa_and_reference(window, chunk, hkv):
    r = np.random.default_rng(window + chunk)
    q = r.standard_normal((2, 20, 4, 8)).astype(np.float32)
    k = r.standard_normal((2, 20, hkv, 8)).astype(np.float32)
    v = r.standard_normal((2, 20, hkv, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    jq, jk, jv, jp = map(jnp.asarray, (q, k, v, pos))
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    plain = attention._sdpa(tq, tk, tv, tp, tp, window)
    chunked = attention._chunked_sdpa(tq, tk, tv, tp, tp, window, chunk)
    want = jax_attn._chunked_sdpa(jq, jk, jv, jp, jp, window, chunk)
    np.testing.assert_allclose(chunked.numpy(), plain.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(
        plain.numpy(), np.asarray(jax_attn._sdpa(jq, jk, jv, jp, jp, window)),
        atol=1e-6, rtol=0)


# -------------------------------------------------------------- the model

def _lm_batch(cfg, seed, b=3, s=32, mask=False):
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (r.random((b, s)) > 0.3).astype(np.float32)
    return batch


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_loss_and_grad_match_reference(name):
    jcfg, tcfg = _cfgs(name)
    jparams = jax_model.init_params(jcfg, jax.random.key(5))
    tparams = params_from_numpy(_np(jparams), "cpu")
    assert list(store._flatten(tparams)) == list(jax_store._flatten(jparams))
    # the loss mask on the base shape only (one JAX compile a case)
    for mask in ((False, True) if name == "lm_zipf" else (False,)):
        batch = _lm_batch(tcfg, 1, mask=mask)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        wl = jax.jit(lambda p, b: jax_model.forward(p, b, jcfg)[0])(
            jparams, jb)
        gl = model.forward(tparams, tb, tcfg)[0]
        np.testing.assert_allclose(gl.detach().numpy(), np.asarray(wl),
                                   atol=LOGIT_TOL, rtol=0)
        wloss, wgrad = jax.jit(jax.value_and_grad(
            lambda p, b: jax_model.loss_fn(p, b, jcfg)))(jparams, jb)
        gloss, ggrad = torch.func.grad_and_value(
            lambda p, b: model.loss_fn(p, b, tcfg), argnums=0)(tparams, tb)[::-1]
        assert abs(float(gloss) - float(wloss)) <= LOGIT_TOL
        _assert_tree_close(wgrad, ggrad)


def test_chunked_attention_path_matches_reference():
    """``sq >= attn_chunk_threshold`` takes the online-softmax path: the
    windowed GQA model at a threshold of 16, chunk 12 (padded)."""
    kw = dict(CONFIGS["gqa"], block_pattern=("swa", "attn"), window=9,
              attn_chunk_threshold=16, attn_chunk=12)
    jcfg = jax_configs.get_reduced("llama-60m", **TINY).replace(**kw)
    tcfg = configs.get_reduced("llama-60m", **TINY).replace(**kw)
    jparams = jax_model.init_params(jcfg, jax.random.key(6))
    tparams = params_from_numpy(_np(jparams), "cpu")
    batch = _lm_batch(tcfg, 2)
    want = jax.jit(lambda p, b: jax_model.forward(p, b, jcfg)[0])(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = model.forward(tparams, tb, tcfg)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)
    unchunked = model.forward(tparams, tb, tcfg.replace(
        attn_chunk_threshold=1 << 30))[0]
    np.testing.assert_allclose(got.numpy(), unchunked.numpy(),
                               atol=LOGIT_TOL, rtol=0)


def test_soap_theta_checkpoint_keys_match_reference():
    jcfg, tcfg = _cfgs("lm_zipf")
    jparams = jax_model.init_params(jcfg, jax.random.key(0))
    want = jax.eval_shape(jax_soap.make().init, jparams)
    want_theta = jax_soap.make().get_precond(want)
    got = zero_theta(soap.make(), params_from_numpy(_np(jparams), "cpu"))
    assert list(store._flatten(got)) == list(jax_store._flatten(want_theta))
    flat = store._flatten(got)
    assert flat["LR/embed/tok"] is None
    assert tuple(flat["LR/blocks/0/mlp/w_up/R"].shape) == (2, 128, 128)


# ------------------------------------------------------------- histories

RUNS = {
    "fedpac_soap": dict(opt_kwargs={"eps": 1e-3}),
    "fedpac_sophia": dict(lr=2e-2),
    "fedpac_muon": {},
}
FL = dict(rounds=ROUNDS, local_steps=3, n_clients=8, participation=0.25)


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for algo, kw in RUNS.items():
        exp = jax_build(algo, scenario="lm_zipf", **FL, **kw)
        out[algo] = (exp.run(), _np(exp.scenario.params))
    return out


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _reference_probes(seed, s, k_steps, k, shapes):
    """Stacked (S, ...) probes of step ``k`` of a round whose key is
    ``jax.random.key(seed)``: round key -> S clients -> K steps ->
    leaves (``repro.core.client.hutchinson_estimate``'s split order)."""
    def one(key):
        keys = jax.random.split(key, len(shapes))
        return [jax.random.rademacher(kk, sh).astype(jnp.float32)
                for kk, sh in zip(keys, shapes)]
    clients = jax.random.split(jax.random.key(seed), s)
    steps = jax.vmap(lambda c: jax.random.split(c, k_steps)[k])(clients)
    return jax.vmap(one)(steps)


def _port_run(algo, kw, jax_params):
    scn = materialize("lm_zipf", seed=0, device="cpu")
    scn = dataclasses.replace(scn, params=params_from_numpy(jax_params, "cpu"))
    exp = build_experiment(algo, scenario=scn, device="cpu", **FL, **kw)
    if exp.opt.needs_hessian:
        s = max(1, int(round(exp.fed.n_clients * exp.fed.participation)))
        like = exp.server.params
        shapes = tuple(tuple(x.shape) for x in tree_leaves(like))

        def probe_fn(seed, k):
            leaves = _reference_probes(seed, s, exp.fed.local_steps, k,
                                       shapes)
            by_path = {path: torch.from_numpy(np.array(x))
                       for (path, _), x in zip(tree_flatten_with_path(like),
                                               leaves)}
            return tree_map_with_path(lambda path, _: by_path[path], like)

        exp.round_fn = build_round_fn(
            exp.spec, exp.loss_fn, exp.opt, lr=exp.lr,
            local_steps=exp.fed.local_steps,
            beta=exp.spec.resolve_beta(exp.fed.beta),
            hessian_freq=exp.fed.hessian_freq, transport=exp.transport,
            n_clients=exp.fed.n_clients, probe_fn=probe_fn)
    return exp.run()


@pytest.mark.parametrize("algo", list(RUNS))
def test_lm_history_matches_reference(jax_runs, algo):
    want, jax_params = jax_runs[algo]
    got = _port_run(algo, RUNS[algo], jax_params)
    tol, rel = ((SOAP_TOL, SOAP_REL_TOL) if algo == "fedpac_soap"
                else (TIGHT_TOL, TIGHT_REL_TOL))
    assert len(got) == len(want) == ROUNDS
    bad = []
    for r, (w, g) in enumerate(zip(want, got)):
        for k in ("round", "upload_bytes", "beta", "freshness"):
            if g[k] != w[k]:
                bad.append((r, k, w[k], g[k]))
        for k, t in tol.items():
            if abs(w[k] - g[k]) > t:
                bad.append((r, k, w[k], g[k]))
        for k, t in rel.items():
            if abs(w[k] - g[k]) > t * abs(w[k]):
                bad.append((r, k, w[k], g[k]))
    assert bad == []
    # the first round starts at the uniform model's loss, ln(256)
    assert abs(got[0]["loss"] - np.log(256)) < 0.1
